"""Training launcher of the port: the train loop of ``repro.launch.train``
on the local mesh of one device, the card by default (``--device cpu`` for
a reduced run on the CPU).  The same flags as the reference's plus
``--device``, the same warmup and schedule, and the same progress lines.
The parameters are placed by the training rule set (``rules_for(cfg,
"train", mesh)``) as the reference places them; on the 1x1 mesh that is
the one device, and a mesh axis wider than 1 raises (training across
cards is ROADMAP Queue A 15).  On the card the attention's gradients come
from the hand-written flash backward kernel; the layers run under
``cfg.remat``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --full --steps 20 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, get_config
from ..data import lm_batches
from ..models import build_model
from ..sharding import named_shardings, resolve_specs, rules_for
from ..tree import tree_map
from ..training import (AdamW, make_lr_schedule, make_train_step,
                        save_checkpoint)
from .mesh import make_local_mesh


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def schedule_for(steps: int):
    """The reference launcher's schedule for a run of ``steps``."""
    return make_lr_schedule(warmup=max(2, steps // 10), total=steps)


def place_params(params, shardings):
    """``params`` on the devices of their ``NamedSharding`` leaves: every
    leaf whole on the mesh's one device.  A spec naming a mesh axis wider
    than 1 raises: cutting a parameter over cards is Queue A 15."""
    def put(p, sh):
        wide = sh.wide()
        if wide:
            raise NotImplementedError(
                f"parameter spec {sh.spec} names mesh axes of size > 1 "
                f"({wide}): training across cards is ROADMAP Queue A 15")
        return p.to(sh.devices.flat[0])
    return tree_map(put, params, shardings)


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    model = build_model(cfg)
    mesh = make_local_mesh(devices=[dev])
    shardings = named_shardings(mesh, resolve_specs(
        model.param_specs(), rules_for(cfg, "train", mesh)))
    params = place_params(
        model.init(torch.Generator(device=dev).manual_seed(0)), shardings)
    opt = AdamW(learning_rate=args.lr, moment_dtype=cfg.moment_dtype)
    state = opt.init(params)
    step_fn = make_train_step(model, opt, schedule_for(args.steps))
    data = lm_batches(cfg.vocab_size, args.batch, args.seq, seed=0)
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        params, state, metrics = step_fn(params, state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)",
                  flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, state, step=args.steps)
        print("checkpoint ->", args.checkpoint)


if __name__ == "__main__":
    main()
