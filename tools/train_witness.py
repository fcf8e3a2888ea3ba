"""The same train steps on the card (the flash kernels forward and
backward) and on the CPU (their plain versions), from the same bf16
weights over the same batches: both loss paths, step by step.

    PYTHONPATH=src python tools/train_witness.py [--arch olmoe-1b-7b] \
        [--layers 2] [--batch 8] [--seq 512] [--steps 5] [--lrs 3e-4 1e-3]

The config is cut to ``--layers`` layers at full width, its weights drawn
from seed 0; each learning rate runs ``--steps`` steps of
``make_train_step`` (AdamW, ``launch/train.py``'s schedule) over
``lm_batches`` of seed 0 on each device.  Where the two paths agree, the
jumps and falls of the loss belong to the model and the optimizer, not to
a kernel.  Needs a card.  olmoe-1b-7b cut to 2 layers at B 8 x S 512
takes about 20 minutes of CPU time for each learning rate.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch.train import schedule_for  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import AdamW, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402


def loss_path(model, params, device, args, lr):
    """(losses, aux losses, seconds) of ``args.steps`` steps on ``device``
    from ``params`` (moved there)."""
    params = tree_unflatten(params, [t.to(device)
                                     for t in tree_leaves(params)])
    opt = AdamW(learning_rate=lr, moment_dtype=model.cfg.moment_dtype)
    state = opt.init(params)
    step = make_train_step(model, opt, schedule_for(args.steps))
    data = lm_batches(model.cfg.vocab_size, args.batch, args.seq, seed=0)
    losses, auxes = [], []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        params, state, mt = step(params, state, batch)
        losses.append(float(mt["loss"]))
        auxes.append(float(mt["aux_loss"]))
    return losses, auxes, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lrs", type=float, nargs="+", default=[3e-4, 1e-3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_witness: needs a card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = get_config(args.arch).with_overrides(n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    print(f"{cfg.name} cut to {cfg.n_layers} layers, B {args.batch} x S "
          f"{args.seq}, {args.steps} steps, {torch.get_num_threads()} CPU "
          f"threads")
    for lr in args.lrs:
        paths = {dev: loss_path(model, params, torch.device(dev), args, lr)
                 for dev in ("cuda", "cpu")}
        for dev, (losses, auxes, secs) in paths.items():
            print(f"  lr {lr:g} {dev}: losses {[round(x, 4) for x in losses]}"
                  f", aux {[round(x, 6) for x in auxes]} ({secs:.1f} s)")
        gap = max(abs(a - b) for a, b in zip(paths["cuda"][0],
                                             paths["cpu"][0]))
        print(f"  lr {lr:g}: largest |card - CPU| loss {gap:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
