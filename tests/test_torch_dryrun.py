"""``repro_torch.launch.dryrun``: the shape pass on the meta device, its
records, the train step's parts against the whole step, the serving
min-tp report against the reference's, and the batched plain SSD scan the
meta branch takes."""

import dataclasses
import importlib
import json
import os

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.build import shape_pass
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_batched_reference,
                                              ssd_chunked_reference)
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import HW
from repro_torch.models import build_model
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.train_loop import make_train_step
from repro_torch.tree import tree_map

# the reference's run_case record keys
REF_KEYS = {"arch", "shape", "multi_pod", "mode", "status", "n_chips",
            "flops_per_chip", "bytes_per_chip", "hlo_flops_per_chip",
            "hlo_bytes_per_chip", "analytic_floors",
            "collective_bytes_per_chip", "hlo_collective_bytes_per_chip",
            "collective_breakdown", "collective_counts", "roofline",
            "model_flops_per_chip", "useful_flops_ratio", "memory",
            "fits_hbm", "compile_s"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes"}


def reference_dryrun():
    """``repro.launch.dryrun``, imported without letting its module-level
    XLA_FLAGS (512 host devices) reach this process's JAX."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("llama3.2-1b", "train_4k", False),
    ("llama3.2-1b", "decode_32k", True),
    ("mamba2-2.7b", "prefill_32k", False)])
def test_run_case_on_meta(arch, shape, multi_pod):
    rec = dryrun.run_case(arch, shape, multi_pod)
    assert rec["status"] == "ok"
    assert REF_KEYS <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["n_chips"] == (512 if multi_pod else 256)
    assert rec["flops_per_chip"] >= rec["model_flops_per_chip"] > 0
    assert rec["hlo_flops_per_chip"] > 0 and rec["hlo_bytes_per_chip"] > 0
    # the terms are the card's: HW's peaks, not a TPU's
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops_per_chip"] / HW["peak_flops"]
    assert r["memory_s"] == rec["bytes_per_chip"] / HW["hbm_bw"]
    assert r["collective_s"] == rec["collective_bytes_per_chip"] \
        / HW["link_bw"]
    assert rec["fits_hbm"] == (rec["memory"]["peak_bytes"]
                               <= HW["hbm_bytes"])
    # no counterpart of the HLO collectives: None, with the reason
    for key in ("hlo_collective_bytes_per_chip", "collective_breakdown",
                "collective_counts"):
        assert rec[key] is None and rec["not_measured"][key]
    assert rec["collective_bytes_per_chip"] \
        == rec["analytic_floors"]["collective_floor"]
    assert rec["memory"]["temp_bytes"] > 0
    json.dumps(rec)
    assert not torch.cuda.is_initialized()


def test_skipped_case():
    rec = dryrun.run_case("seamless-m4t-medium", "long_500k", False)
    assert rec["status"] == "skipped" and rec["reason"]


def test_serve_mode_is_the_reference_rule():
    ref = reference_dryrun()
    from repro.configs import ARCH_IDS, get_config as ref_get_config
    for arch in ARCH_IDS:
        assert dryrun.serve_mode(get_config(arch)) \
            == ref.serve_mode(ref_get_config(arch)), arch


def _meta_case(arch: str, accum: int, batch: int = 6, seq: int = 32):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              grad_accum=accum)
    model = build_model(cfg)
    opt = AdamW(moment_dtype=cfg.moment_dtype)
    step = make_train_step(model, opt)
    params = tree_map(lambda s: torch.empty(tuple(s.shape), dtype=s.dtype,
                                            device="meta"), model.template())
    state = opt.init(params)._asdict()
    batch = {k: torch.empty((batch, seq), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}

    def train(p, s, b):
        return step(p, AdamWState(**s), b)
    train.parts = (model, opt, lambda count: 1.0, accum)
    return train, (params, state, batch)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b",
                                  "mamba2-2.7b"])
@pytest.mark.parametrize("accum", [2, 3])
def test_train_parts_count_the_whole_step(arch, accum):
    """The train step's parts, weighted by how often the step runs each,
    give the whole step's FLOPs and bytes exactly."""
    fn, args = _meta_case(arch, accum)
    with shape_pass():
        with dryrun._Counts() as c:
            fn(*args)
        assert dryrun._train_parts(fn, args) == c.totals()


def test_train_parts_peak_holds_the_accumulated_gradients():
    """The parts' peak holds the accumulated gradients (the parameters'
    bytes) beside a microbatch's pass: above the peak of a one-microbatch
    step on the same microbatch."""
    fn, args = _meta_case("llama3.2-1b", 3)
    live = dryrun._BytesMode(track_live=True)
    one, one_args = _meta_case("llama3.2-1b", 1, batch=2)
    single = dryrun._BytesMode(track_live=True)
    with shape_pass():
        dryrun._train_parts(fn, args, live=live)
        with single:
            one(*one_args)
    params = sum(t.numel() * t.element_size()
                 for t in torch.utils._pytree.tree_leaves(args[0]))
    assert live.peak >= params
    assert live.peak > single.peak > 0


def test_min_tp_report_matches_the_reference():
    """The ladders over the port's estimate equal the reference's at the
    reference's budget (read from the reference: the port never holds
    it)."""
    ref = reference_dryrun()
    from repro.launch.roofline import HW as REF_HW
    want = ref.min_tp_report()
    got = dryrun.min_tp_report(hbm_bytes=REF_HW["hbm_bytes"])
    assert got == want


def test_min_tp_report_at_the_cards_budget():
    rep = dryrun.min_tp_report()
    assert set(rep) == set(dryrun.MIN_TP_ARCHS)
    for rec in rep.values():
        for parallel in ("exact", "efficient"):
            ladder = rec[parallel]["ladder"]
            assert [r["tp"] for r in ladder] == [2 ** i for i in range(9)]
            fits = [r["tp"] for r in ladder if r["fits"]]
            assert rec[parallel]["min_tp"] == (fits[0] if fits else None)


def test_main_writes_records(tmp_path, capsys):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                 "--out", str(out)])
    recs = json.loads(out.read_text())
    assert recs["qwen2-1.5b|decode_32k|single"]["status"] == "ok"
    assert "done: 1 ok, 0 skipped, 0 errors of 1" in capsys.readouterr().out
    dryrun.main(["--min-tp", "--out", str(out)])
    assert set(json.loads(out.read_text())["min_tp"]) \
        == set(dryrun.MIN_TP_ARCHS)


@pytest.mark.parametrize("s,q,init", [(100, 32, False), (256, 64, True),
                                      (77, 256, True)])
def test_batched_ssd_reference_is_the_chunked_one(s, q, init):
    """The meta branch's plain scan: bit-identical to the chunked plain
    version on the CPU (chunks batched, the carried state stepped)."""
    g = torch.Generator().manual_seed(s)
    b, h, p, n = 2, 3, 4, 5
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g)
    a = torch.rand(b, s, h, generator=g) * 0.5 + 0.5
    bm = torch.randn(b, s, n, generator=g)
    cm = torch.randn(b, s, n, generator=g)
    st = torch.randn(b, h, p, n, generator=g) if init else None
    y1, s1 = ssd_chunked_reference(x, dt, a, bm, cm, st, chunk=q)
    y2, s2 = ssd_chunked_batched_reference(x, dt, a, bm, cm, st, chunk=q)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_kernel_ops_take_their_plain_versions_on_meta():
    """Inside ``shape_pass`` the flash, decode and SSD ops give the plain
    versions' shapes on meta tensors (outside it they refuse meta:
    tests/test_torch_kernels.py, tests/test_torch_ssm.py)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    with shape_pass():
        _meta_ops(m, flash_attention, decode_attention_op, ssd_scan)
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_ops(m, flash_attention, decode_attention_op, ssd_scan)
    assert not torch.cuda.is_initialized()


def _meta_ops(m, flash_attention, decode_attention_op, ssd_scan):
    out = flash_attention(m(2, 64, 8, 64), m(2, 64, 2, 64), m(2, 64, 2, 64),
                          m(64, dtype=torch.int32), m(64, dtype=torch.int32))
    assert out.shape == (2, 64, 8, 64) and out.device.type == "meta"
    out = decode_attention_op(m(2, 8, 64), m(2, 128, 2, 64),
                              m(2, 128, 2, 64), m(2, dtype=torch.int32))
    assert out.shape == (2, 8, 64) and out.device.type == "meta"
    y, st = ssd_scan(m(2, 300, 4, 8), m(2, 300, 4, dtype=torch.float32),
                     m(2, 300, 4, dtype=torch.float32), m(2, 300, 16),
                     m(2, 300, 16), chunk=64)
    assert y.shape == (2, 300, 4, 8) and st.shape == (2, 4, 8, 16)
