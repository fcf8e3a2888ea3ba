"""Multi-pod dry-run on the meta device (the port of
``repro.launch.dryrun``): every (architecture x input shape) on the
production meshes, priced by a shape-only pass instead of XLA's lower and
compile.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --min-tp

A case runs its step (the train step with AdamW state, the prefill, or one
decode step) once at the case's global shapes on ``torch.device("meta")``:
nothing is allocated and no card is touched.  ``FlopCounterMode`` counts
the FLOPs and ``_BytesMode`` sums each non-view op's input and output
bytes (the counterpart of XLA's "bytes accessed"); per device is global /
n_chips, and the record keeps the reference's max(counted, analytic
floor).  Argument and output bytes per device come from the resolved
specs, each dim divided by its mesh axes.  ``temp_bytes`` is the peak of
live meta-tensor bytes made inside a pass at the per-device batch
(``batch_axes``): an upper bound, since that pass holds the whole
weights, their gradients and the unsharded activations of the model axis.
The passes run inside ``kernels.build.shape_pass``, where the kernel ops
take their plain versions on meta (for shapes), so the attention's
temporaries are the plain version's score matrices.

The reference reads its collective bytes from the optimized HLO; the port
has none, so ``hlo_collective_bytes_per_chip``, ``collective_breakdown``
and ``collective_counts`` are None (``not_measured`` says why) and the
collective term is the analytic floor alone.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, SHAPE_IDS, get_config, get_shape
from ..kernels.build import shape_pass
from ..models import build_model
from ..sharding.context import activation_sharding
from ..sharding.partitioning import (NamedSharding, batch_axes,
                                     kv_cache_spec, logits_spec, pspec,
                                     resolve_specs, rules_for, ssm_state_spec)
from ..training.optimizer import AdamW, AdamWState
from ..training.train_loop import loss_and_grads, make_train_step
from ..tree import tree_items, tree_leaves, tree_map, tree_unflatten
from .mesh import make_production_mesh
from .roofline import HW, analytic_floors, model_flops, roofline_terms

__all__ = ["SKIPS", "serve_mode", "input_specs", "cache_specs",
           "build_case", "run_case", "MIN_TP_ARCHS", "min_tp_report",
           "print_min_tp", "main"]

META = torch.device("meta")

SKIPS = {
    ("seamless-m4t-medium", "long_500k"):
        "enc-dec with full cross-attention has no sub-quadratic 500k path",
}

NOT_MEASURED = ("the port has no compiled HLO to read collectives from; "
                "the collective term is the analytic floor")


def serve_mode(cfg) -> str:
    """'serve' or 'serve_big' (2-D weight storage) by per-device weight
    size.  The 10e9-byte threshold is the reference's rule, kept so that
    both packages pick the same mode; it is not a figure of the card."""
    per_dev = cfg.param_count() * 2 / cfg.model_parallel
    return "serve_big" if per_dev > 10e9 else "serve"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg, shape, mesh, batch: int | None = None):
    """Meta tensors and specs of the step's batch inputs, at the global
    batch (or ``batch`` rows)."""
    B, S = batch or shape.global_batch, shape.seq_len
    b_ax = batch_axes(mesh, shape.global_batch)
    D = cfg.d_model
    inputs, specs = {}, {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            se = S // 2
            inputs["frames"] = _meta((B, se, D), torch.bfloat16)
            inputs["tokens"] = _meta((B, S - se), torch.int32)
            specs["frames"] = pspec(b_ax, None, None)
            specs["tokens"] = pspec(b_ax, None)
        elif cfg.family == "vlm":
            pt = min(cfg.n_frontend_tokens, S // 2)
            inputs["patches"] = _meta((B, pt, D), torch.bfloat16)
            inputs["tokens"] = _meta((B, S - pt), torch.int32)
            specs["patches"] = pspec(b_ax, None, None)
            specs["tokens"] = pspec(b_ax, None)
        else:
            inputs["tokens"] = _meta((B, S), torch.int32)
            specs["tokens"] = pspec(b_ax, None)
        if shape.kind == "train":
            inputs["labels"] = _meta(inputs["tokens"].shape, torch.int32)
            specs["labels"] = pspec(b_ax, None)
    return inputs, specs


def cache_specs(cfg, model, shape, mesh, mode, batch: int | None = None):
    """Decode-cache meta tensors and specs (the reference's
    ``cache_specs``), at the global batch (or ``batch`` rows)."""
    B, S = batch or shape.global_batch, shape.seq_len
    s_max = cfg.window if cfg.attention_kind == "sliding_window" else S
    enc_len = min(cfg.n_frontend_tokens or 4096, 4096)
    shapes = model.cache_shapes(B, s_max, enc_len=enc_len)
    cache = _meta_tree(shapes)
    kv_spec = kv_cache_spec(cfg, mode, mesh, shape.global_batch)
    specs = {}
    for name in shapes:
        if name in ("k", "v", "cross_k", "cross_v"):
            specs[name] = kv_spec
        elif name == "ssm":
            specs[name] = ssm_state_spec(cfg, mode, mesh, shape.global_batch)
    return cache, specs


def _meta_tree(shapes):
    """Meta tensors for a nested {name: (shape, dtype)} tree."""
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return _meta(*shapes)


def build_case(arch: str, shape_name: str, mesh, batch: int | None = None):
    """(fn, args, in_specs, out_specs, meta): ``fn(*args)`` runs the
    case's step on meta tensors at the global batch (or ``batch`` rows);
    the specs are trees of resolved specs over ``args`` and the outputs
    (None: replicated)."""
    shape = get_shape(shape_name)
    cfg = get_config(arch, long_context=shape_name == "long_500k")
    model = build_model(cfg)
    mode = "train" if shape.kind == "train" else serve_mode(cfg)
    rules = rules_for(cfg, mode, mesh)
    param_specs = resolve_specs(model.param_specs(), rules)
    params = tree_map(lambda s: _meta(tuple(s.shape), s.dtype),
                      model.template())
    inputs, input_pspecs = input_specs(cfg, shape, mesh, batch)
    b_ax = batch_axes(mesh, shape.global_batch)

    if shape.kind == "train":
        opt = AdamW(moment_dtype=cfg.moment_dtype)
        step = make_train_step(model, opt)
        opt_state = opt.init(params)._asdict()
        opt_specs = {"count": (), "m": param_specs, "v": param_specs}

        def train(p, s, b):
            new_p, new_s, metrics = step(p, AdamWState(**s), b)
            return new_p, new_s._asdict(), metrics
        # what the step is made of, for _train_parts
        train.parts = (model, opt, lambda count: 1.0, max(1, cfg.grad_accum))
        in_specs = (param_specs, opt_specs, input_pspecs)
        out_specs = (param_specs, opt_specs,
                     {"loss": (), "lm_loss": (), "aux_loss": ()})
        return train, (params, opt_state, inputs), in_specs, out_specs, \
            dict(cfg=cfg, mode=mode, donate=(0, 1),
                 donated=(params, opt_state))

    cache, csp = cache_specs(cfg, model, shape, mesh, mode, batch)
    lspec = logits_spec(mesh, mode, shape.global_batch)
    if shape.kind == "prefill":
        def prefill(p, b):
            return model.prefill(p, b)
        return prefill, (params, inputs), (param_specs, input_pspecs), \
            (lspec, csp), dict(cfg=cfg, mode=mode, donate=(), donated=())

    B = batch or shape.global_batch

    def decode(p, token, c, cache_len):
        return model.decode_step(p, token, c, cache_len)
    token = _meta((B, 1), torch.int32)
    cache_len = _meta((B,), torch.int32)
    return decode, (params, token, cache, cache_len), \
        (param_specs, pspec(b_ax, None), csp, pspec(b_ax)), (lspec, csp), \
        dict(cfg=cfg, mode=mode, donate=(2,), donated=(cache,))


# --------------------------------------------------------- the shape pass

def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every tensor argument and result of each op that
    moves data (view ops excluded) and, optionally, tracks the live bytes
    of the storages the ops make (``peak``)."""

    def __init__(self, track_live: bool = False):
        super().__init__()
        self.accessed = 0
        self.track_live = track_live
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs)) + _tensors(out))
        if self.track_live:
            for t in _tensors(out):
                self._track(t.untyped_storage())
        return out

    def _track(self, storage) -> None:
        key = storage._cdata
        if key in self._sizes:
            return
        n = storage.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key)


def _per_device_bytes(tensors, specs, mesh) -> int:
    """Bytes a device holds of a tree of tensors under a tree of resolved
    specs: each dim divided (rounded up) by the sizes of its mesh axes."""
    sharding = {path: NamedSharding(mesh, tuple(spec))
                for path, spec in tree_items(specs)}
    total = 0
    for path, t in tree_items(tensors):
        if not isinstance(t, torch.Tensor):
            continue
        sh = sharding.get(path)
        dims = list(t.shape)
        if sh is not None:
            for i, entry in enumerate(sh.spec[:len(dims)]):
                dims[i] = -(-dims[i] // sh.axis_size(entry))
        total += math.prod(dims) * t.element_size()
    return total


def _tuple_tree(items) -> dict:
    """A tuple of trees as one tree keyed by position."""
    return {i: x for i, x in enumerate(items)}


def _activation_shardings(mesh, mode: str):
    """The reference's training activation specs (sequence over 'model'),
    and the expert buffer's spec in every mode."""
    expert = NamedSharding(mesh, ("model", None, None))
    if mode != "train":
        return None, None, None, None, expert
    b_ax = batch_axes(mesh, None)
    return (NamedSharding(mesh, pspec(b_ax, "model", None)),
            NamedSharding(mesh, pspec(b_ax, None, "model", None)),
            NamedSharding(mesh, pspec(b_ax, None, "model")),
            NamedSharding(mesh, pspec(b_ax, "model", None, None)),
            expert)


class _Counts:
    """FLOPs and bytes accessed of the ops run inside (and, with
    ``track_live``, the peak of live result bytes)."""

    def __init__(self, track_live: bool = False):
        self.flops = FlopCounterMode(display=False)
        self.bytes = _BytesMode(track_live=track_live)

    def __enter__(self):
        self.flops.__enter__()
        self.bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self.bytes.__exit__(*exc)
        self.flops.__exit__(*exc)

    def totals(self) -> tuple[float, float]:
        return float(self.flops.get_total_flops()), float(self.bytes.accessed)


def _train_parts(fn, args, live: _BytesMode | None = None):
    """(flops, bytes) of the train step ``fn(*args)`` of a config with
    ``grad_accum`` = A > 1, from its parts, each run once on meta and
    weighted by how often the step runs it: ``loss_and_grads`` on one
    microbatch (A times: the microbatches share one shape, so their counts
    are equal), the sum into the accumulated gradients (A - 1 times), and
    the division, the loss means and the AdamW update (once).  A full pass
    of nemotron-4-340b (16 microbatches x 96 layers) would take minutes
    of meta dispatch; the parts give the same counts
    (``tests/test_torch_dryrun.py`` holds them to the whole step).  With
    ``live`` the parts run in the step's order with the accumulated
    gradients live, and ``live.peak`` is the step's peak."""
    model, opt, sched, accum = fn.parts
    params, state, batch = args
    micro = {k: v[:v.shape[0] // accum] for k, v in batch.items()}
    leaves = tree_leaves(params)
    scalar = _meta((), torch.float32)     # a microbatch's loss
    total_f = total_b = 0.0
    if live is not None:
        with live:
            acc = [torch.empty_like(p) for p in leaves]
            _, _, g = loss_and_grads(model, params, micro)
            acc = [a + b.to(a.dtype) for a, b in zip(acc, g)]
            del g
            acc = [a / accum for a in acc]
            opt.update(tree_unflatten(params, acc), AdamWState(**state),
                       params, lr_scale=sched(state["count"]))
        return None
    for times, part in (
            (accum, lambda: loss_and_grads(model, params, micro)),
            (accum - 1, lambda: [a + b.to(a.dtype)
                                 for a, b in zip(leaves, leaves)]),
            (1, lambda: ([a / accum for a in leaves],
                         [torch.stack([scalar] * accum).mean()
                          for _ in range(3)])),
            (1, lambda: opt.update(params, AdamWState(**state), params,
                                   lr_scale=sched(state["count"])))):
        with _Counts() as c:
            part()
        f, b = c.totals()
        total_f += times * f
        total_b += times * b
    return total_f, total_b


def _accum(fn) -> int:
    """The microbatches of a train case's step (1 for the other steps)."""
    parts = getattr(fn, "parts", None)
    return parts[3] if parts else 1


def _global_pass(arch: str, shape_name: str, mesh, cache: dict) -> dict:
    """FLOPs and bytes accessed of one pass at the global shapes, and the
    per-device argument, output and donated bytes.  The counts do not
    depend on the mesh (the hooks are the identity on meta), so ``cache``
    keeps them, by (arch, shape), for the other mesh of a sweep."""
    fn, args, in_specs, out_specs, meta = build_case(arch, shape_name, mesh)
    key = (arch, shape_name)
    if key not in cache:
        with shape_pass(), activation_sharding(
                *_activation_shardings(mesh, meta["mode"])):
            if _accum(fn) > 1:
                # the step's outputs: new parameters and optimizer state of
                # the inputs' shapes, and three f32 scalars
                scalar = _meta((), torch.float32)
                out = (args[0], args[1], {"loss": scalar, "lm_loss": scalar,
                                          "aux_loss": scalar})
                counts = _train_parts(fn, args)
            else:
                with _Counts() as c:
                    out = fn(*args)
                counts = c.totals()
        cache[key] = counts + (out,)
    flops, nbytes, outputs = cache[key]
    return {"flops": flops, "bytes": nbytes,
            "argument_bytes": _per_device_bytes(
                _tuple_tree(args), _tuple_tree(in_specs), mesh),
            "output_bytes": _per_device_bytes(
                _tuple_tree(outputs), _tuple_tree(out_specs), mesh),
            "alias_bytes": _per_device_bytes(
                _tuple_tree(meta["donated"]),
                _tuple_tree(tuple(in_specs[i] for i in meta["donate"])),
                mesh),
            "cfg": meta["cfg"], "mode": meta["mode"]}


def _temp_pass(arch: str, shape_name: str, mesh) -> int:
    """Peak live bytes of the ops' results in a pass at the per-device
    batch."""
    shape = get_shape(shape_name)
    b_ax = batch_axes(mesh, shape.global_batch)
    div = math.prod(mesh.shape[a] for a in b_ax) if b_ax else 1
    fn, args, _, _, meta = build_case(arch, shape_name, mesh,
                                      batch=shape.global_batch // div)
    live = _BytesMode(track_live=True)
    with shape_pass(), activation_sharding(
            *_activation_shardings(mesh, meta["mode"])):
        if _accum(fn) > 1:
            _train_parts(fn, args, live=live)
        else:
            with live:
                out = fn(*args)
                del out
    return live.peak


def run_case(arch: str, shape_name: str, multi_pod: bool,
             check_fit: bool = False, cache: dict | None = None) -> dict:
    """One case's record: the reference's keys, from the meta passes."""
    t0 = time.time()
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    g = _global_pass(arch, shape_name, mesh, {} if cache is None else cache)
    temp = _temp_pass(arch, shape_name, mesh)
    cfg, mode = g["cfg"], g["mode"]
    shape = get_shape(shape_name)
    flops = g["flops"] / n_chips
    bytes_acc = g["bytes"] / n_chips
    floors = analytic_floors(cfg, shape, n_chips)
    coll = floors["collective_floor"]
    terms = roofline_terms(max(flops, floors["flops_floor"]),
                           max(bytes_acc, floors["bytes_floor"]), coll)
    mf = model_flops(cfg, shape, n_chips)
    memory = {"argument_bytes": g["argument_bytes"],
              "output_bytes": g["output_bytes"],
              "temp_bytes": temp,
              "alias_bytes": g["alias_bytes"]}
    memory["peak_bytes"] = (memory["argument_bytes"] + memory["output_bytes"]
                            + temp - memory["alias_bytes"])
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mode": mode, "status": "ok",
        "n_chips": n_chips,
        "flops_per_chip": max(flops, floors["flops_floor"]),
        "bytes_per_chip": max(bytes_acc, floors["bytes_floor"]),
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_acc,
        "analytic_floors": floors,
        "collective_bytes_per_chip": coll,
        "hlo_collective_bytes_per_chip": None,
        "collective_breakdown": None,
        "collective_counts": None,
        "not_measured": {k: NOT_MEASURED for k in (
            "hlo_collective_bytes_per_chip", "collective_breakdown",
            "collective_counts")},
        "roofline": terms,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": (mf / max(flops, floors["flops_floor"]))
        if flops else None,
        "memory": memory,
        "fits_hbm": bool(memory["peak_bytes"] <= HW["hbm_bytes"]),
        "compile_s": round(time.time() - t0, 1),
    }
    return rec


# ---------------------------------------------------- serving min-tp report

MIN_TP_ARCHS = ("deepseek-moe-16b", "nemotron-4-340b")


def min_tp_report(archs=MIN_TP_ARCHS, *, n_slots: int = 64,
                  max_seq_len: int = 4096, page_size: int = 16,
                  max_tp: int = 256, hbm_bytes: int = HW["hbm_bytes"]) -> dict:
    """Smallest serving width that fits one shard per device, per arch and
    per parallel mode, priced by ``serving.sharded.estimate_device_bytes``
    (template arithmetic: no allocation) over a pow2 tp ladder, at a
    budget of ``hbm_bytes`` a device (the card's by default)."""
    from ..serving.sharded import estimate_device_bytes
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        model = build_model(cfg)
        n_pages = n_slots * (-(-max_seq_len // page_size)) + 1  # + scratch
        rec = {}
        for parallel in ("exact", "efficient"):
            ladder, fit = [], None
            tp = 1
            while tp <= max_tp:
                est = estimate_device_bytes(
                    model, tp=tp, parallel=parallel, n_pages=n_pages,
                    page_size=page_size, n_slots=n_slots)
                fits = est["total_bytes"] <= hbm_bytes
                ladder.append({
                    "tp": tp, "fits": fits,
                    "total_gib": round(est["total_bytes"] / 2**30, 2),
                    "weights_gib": round(est["weights_bytes"] / 2**30, 2),
                    "kv_pool_gib": round(est["kv_pool_bytes"] / 2**30, 2),
                    "replicated_gib":
                        round(est["replicated_bytes"] / 2**30, 2),
                    "fallbacks": list(est["report"]["fallbacks"]),
                })
                if fit is None and fits:
                    fit = tp
                tp *= 2
            rec[parallel] = {"min_tp": fit, "ladder": ladder}
        out[arch] = rec
    return out


def print_min_tp(report: dict, hbm_bytes: int = HW["hbm_bytes"]) -> None:
    hbm = hbm_bytes / 2**30
    print(f"serving min-tp report (HBM budget {hbm:.2f} GiB/device, "
          f"64 slots x 4k ctx KV pool):")
    for arch, rec in report.items():
        for parallel, r in rec.items():
            print(f"  {arch:18s} {parallel:9s} min_tp={r['min_tp']}")
            for rung in r["ladder"]:
                mark = "fits" if rung["fits"] else "OOM "
                print(f"    tp={rung['tp']:<4d} {mark} "
                      f"total={rung['total_gib']:8.2f} GiB "
                      f"(weights {rung['weights_gib']:.2f}, "
                      f"kv {rung['kv_pool_gib']:.2f}, "
                      f"replicated {rung['replicated_gib']:.2f})"
                      + (f" fallbacks={rung['fallbacks']}"
                         if rung["fallbacks"] else ""))


# worker processes of an --all sweep (spawned; each keeps a few hundred MB)
SWEEP_WORKERS = 4


def _run_group(task) -> list:
    """Run one (arch, shape) on its meshes: [(arch, shape, multi_pod,
    record)], a failure recorded as an error record (a bug to fix)."""
    a, s, pods = task
    out, cache = [], {}
    for mp in pods:
        try:
            rec = run_case(a, s, mp, cache=cache)
        except Exception as e:
            rec = {"arch": a, "shape": s, "multi_pod": mp,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        out.append((a, s, mp, rec))
    return out


def _print_record(rec: dict) -> None:
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"  ok: dominant={r['dominant']} "
              f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
              f"collective={r['collective_s']:.2e}s "
              f"peak={rec['memory']['peak_bytes']/2**30:.2f}GiB "
              f"fits={rec['fits_hbm']} ({rec['compile_s']}s)", flush=True)
    else:
        print(f"  {rec['status']}: {rec.get('reason', rec.get('error'))}",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=SHAPE_IDS)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape x mesh)")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--min-tp", action="store_true",
                    help="serving min-tp report (deepseek-moe-16b + "
                         "nemotron-4-340b, exact vs efficient) instead "
                         "of running cases")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    if args.min_tp:
        report = min_tp_report(
            (args.arch,) if args.arch else MIN_TP_ARCHS)
        print_min_tp(report)
        with open(args.out, "w") as f:
            json.dump({"min_tp": report}, f, indent=1)
        return

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    def key(a, s, mp):
        return f"{a}|{s}|{'multi' if mp else 'single'}"

    cases = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPE_IDS:
                cases.append((a, s, False))
                if not args.single_pod_only:
                    cases.append((a, s, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cases.append((args.arch, args.shape, args.multi_pod))

    todo = []
    for a, s, mp in cases:
        k = key(a, s, mp)
        if k in results and results[k].get("status") in ("ok", "skipped"):
            print(f"[cached] {k}")
            continue
        todo.append((a, s, mp))
    # one task per (arch, shape), its meshes in order (they share the
    # global pass); several tasks go to a few worker processes
    groups = {}
    for a, s, mp in todo:
        groups.setdefault((a, s), []).append(mp)
    tasks = [(a, s, tuple(mps)) for (a, s), mps in groups.items()]
    if len(tasks) > 1:
        pool = ProcessPoolExecutor(
            max_workers=min(SWEEP_WORKERS, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"))
        done = pool.map(_run_group, tasks)
    else:
        pool, done = None, map(_run_group, tasks)
    try:
        for recs in done:
            for a, s, mp, rec in recs:
                k = key(a, s, mp)
                print(f"[dryrun] {k} ...", flush=True)
                results[k] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                _print_record(rec)
    finally:
        if pool is not None:
            pool.shutdown()

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)}")


if __name__ == "__main__":
    main()
