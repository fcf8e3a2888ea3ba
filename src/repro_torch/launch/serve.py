"""Serving launcher of the port: run the end-to-end engine on any --arch of
the dense, SSM (mamba2-2.7b) or hybrid (zamba2-1.2b) families, on the card
by default (``--device cpu`` for a reduced run on the CPU).  The same
flags as ``repro.launch.serve`` plus ``--device``.  The encoder-decoder
(seamless-m4t-medium) is refused, as the reference's CLI refuses it: the
paged engine does not take it, and it runs through ``Model.prefill`` and
``Model.decode_step``.

``--tp N`` serves the dense family tensor-parallel over N cards (the
reference's N devices), ``--parallel exact|efficient`` picks the plan,
and ``--device-memory-gb`` refuses a configuration that does not fit one
device before anything is allocated.  With ``--device cpu`` the N shards
sit on the CPU.  Over N cards the engine's decode steps run eagerly
(``graphs=False``: one CUDA graph cannot span cards, ROADMAP Queue A 15);
on one card they run as CUDA graphs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --full --n-slots 8 --max-seq-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --full --tp 4 --parallel efficient --device-memory-gb 80
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core import Scheduler, make_policy
from ..core.policies import POLICY_NAMES
from ..data import ByteTokenizer
from ..models import build_model
from ..serving import ServeRequest, ServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--policy", default="sagesched", choices=POLICY_NAMES)
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--max-seq-len", type=int, default=192)
    ap.add_argument("--step-mode", default="fused",
                    choices=("fused", "orchestrated"),
                    help="fused = one device call per decode (multi-)step; "
                         "orchestrated = host-side loop")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode tokens per host round-trip (fused mode)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width of the dense family: needs "
                         "tp cards (with --device cpu, tp CPU shards)")
    ap.add_argument("--parallel", default="exact",
                    choices=("exact", "efficient"),
                    help="exact = token-identical sharding (KV pool only); "
                         "efficient = Megatron column/row-parallel "
                         "projections, vocab-sharded logits and LSE-split "
                         "attention, held to the tolerance contract")
    ap.add_argument("--device-memory-gb", type=float, default=None,
                    help="per-device memory budget of the build-time "
                         "preflight (refuses configs that cannot fit one "
                         "shard; default: no check)")
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--gateway", action="store_true",
                    help="serve through the bounded-admission gateway (not "
                         "ported yet: ROADMAP Queue A 8)")
    ap.add_argument("--max-inflight", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--shed-policy", default="cost", choices=("cost", "tail"))
    ap.add_argument("--ttft-deadline", type=float, default=None)
    ap.add_argument("--ttlt-deadline", type=float, default=None)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; finding "
                         "no card is an error)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.gateway:
        raise NotImplementedError(
            "--gateway: the gateway is not ported yet (ROADMAP Queue A 8)")
    cfg = get_config(args.arch, reduced=not args.full)
    if cfg.family == "encdec":
        raise SystemExit("the CLI serving demo drives decoder-only archs; "
                         "see tests/test_models_smoke.py for enc-dec paths")
    tok = ByteTokenizer()
    # tp shards over tp cards: one CUDA graph cannot span them
    graphs = not (args.tp > 1 and torch.device(args.device).type == "cuda")
    if not graphs:
        print(f"tp {args.tp} over {args.tp} cards: decode steps run eagerly "
              "(graphs=False; multi-card graphs are ROADMAP Queue A 15)")
    engine = ServingEngine(
        model=build_model(cfg),
        scheduler=Scheduler(policy=make_policy(args.policy)),
        n_slots=args.n_slots, max_seq_len=args.max_seq_len, seed=0,
        step_mode=args.step_mode, decode_steps=args.decode_steps,
        tp=args.tp, parallel=args.parallel,
        device_memory_gb=args.device_memory_gb, device=args.device,
        graphs=graphs)
    if engine.plan is not None:
        report = {k: v for k, v in engine.sharding_report().items()
                  if k != "tensors"}
        print(f"mesh: {report}")

    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    reqs = []
    topics = ["summarize the report", "write a story", "explain the code",
              "translate the phrase"]
    for i in range(args.n_requests):
        prompt = f"{topics[i % len(topics)]} case {i}"
        reqs.append(ServeRequest(
            request_id=f"req-{i}", prompt=prompt,
            prompt_tokens=tok.encode(prompt)[:64],
            max_new_tokens=int(rng.integers(8, 48)),
            eos_token=tok.eos_id, arrival=t0 + i * 0.01,
            ttft_deadline_s=args.ttft_deadline,
            ttlt_deadline_s=args.ttlt_deadline))
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    print(f"arch={cfg.name} policy={args.policy} device={engine.device} "
          f"{engine.metrics.summary(reqs)}")
    return engine, reqs


if __name__ == "__main__":
    main()
