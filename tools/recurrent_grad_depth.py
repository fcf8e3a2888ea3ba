"""How far a recurrent model's gradients on the card sit from the CPU's,
and from the card's own with the SSD scan's plain backward, by depth.

    PYTHONPATH=src python tools/recurrent_grad_depth.py \
        [--archs zamba2-1.2b mamba2-2.7b] [--depths 2 12 0] [--batch 2] \
        [--seq 512] [--cpu-depth-max 64]

For each arch and depth (0: the config's own), at full width from seed 0
bf16 weights and one ``lm_batches`` batch of seed 0, three gradients of
``Model.loss_fn``: on the card with the SSD backward kernel
(``SSDScanFunction``), on the card with the backward's plain version
(``chip_smoke.plain_ssd_backward``: ``ssd_backward_reference`` on the
same saved tensors, after the same forward),
and on the CPU (the plain versions throughout; skipped above
``--cpu-depth-max`` layers).  Prints each leaf's relative error
(``grad_rel_errors``) of the kernel run against the plain run and against
the CPU, the losses and the seconds each took, with the card's name and
power limit.  These are the numbers behind ``GRAD_REL_BAR_SSM``,
``SSD_PLAIN_GRAD_BAR`` and chip_smoke.py's cut of the card-vs-CPU check
to 2 layers.  Needs a card; mamba2-2.7b at its 64 layers takes about four
minutes of CPU time.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from chip_smoke import plain_ssd_backward  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.testing import grad_rel_errors  # noqa: E402
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_items, tree_leaves, tree_unflatten  # noqa: E402,E501


def timed_grads(model, params, batch, sync):
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(model, params, batch)
    sync()
    return float(loss), [g.cpu() for g in grads], time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+",
                    default=["zamba2-1.2b", "mamba2-2.7b"])
    ap.add_argument("--depths", nargs="+", type=int, default=[2, 12, 0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--cpu-depth-max", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for arch in args.archs:
        for depth in args.depths:
            cfg = get_config(arch)
            if depth:
                cfg = cfg.with_overrides(n_layers=depth)
            model = build_model(cfg)
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            batch = {k: torch.from_numpy(v) for k, v in next(lm_batches(
                cfg.vocab_size, args.batch, args.seq, seed=0)).items()}
            card = {k: v.to(dev) for k, v in batch.items()}
            sync = torch.cuda.synchronize
            lk, gk, tk = timed_grads(model, params, card, sync)
            with plain_ssd_backward():
                lp, gp, tp = timed_grads(model, params, card, sync)
            errs = {"kernel vs plain (card)": grad_rel_errors(gk, gp)}
            del gp
            line = (f"{arch} at {cfg.n_layers} layers, B {args.batch} x S "
                    f"{args.seq}: loss card {lk:.6f} (plain backward "
                    f"{lp:.6f}), card {tk:.2f} s / plain {tp:.2f} s")
            if cfg.n_layers <= args.cpu_depth_max:
                cpu = tree_unflatten(params, [t.cpu() for t in
                                              tree_leaves(params)])
                lc, gc, tc = timed_grads(model, cpu, batch, lambda: None)
                errs["kernel (card) vs CPU"] = grad_rel_errors(gk, gc)
                line += f"; CPU loss {lc:.6f} in {tc:.1f} s"
                del cpu, gc
            print(line)
            print(f"  {'leaf':34s}" + "".join(f"{k:>26s}" for k in errs))
            for i, (path, _) in enumerate(tree_items(params)):
                print(f"  {'/'.join(path):34s}"
                      + "".join(f"{e[i]:26.3e}" for e in errs.values()))
            print("  largest" + " " * 27 + "".join(
                f"{max(e):26.3e}" for e in errs.values()))
            del params, gk
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
