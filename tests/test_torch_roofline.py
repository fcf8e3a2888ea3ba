"""``repro_torch.launch.roofline`` held bit for bit (Python floats) to
``repro.launch.roofline`` on the same inputs and the same ``hw`` dict, at
full configs (pure arithmetic), and its H100 figures."""

import pytest

from repro.configs import ARCH_IDS, SHAPE_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.launch import roofline as ref_roofline
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import roofline

CASES = [(a, s) for a in ARCH_IDS for s in SHAPE_IDS
         if not (a == "seamless-m4t-medium" and s == "long_500k")]


def configs(arch: str, shape: str):
    long_ctx = shape == "long_500k"
    return (get_config(arch, long_context=long_ctx),
            ref_get_config(arch, long_context=long_ctx))


@pytest.mark.parametrize("arch,shape", CASES)
def test_floors_and_model_flops_bit_identical(arch, shape):
    cfg, rcfg = configs(arch, shape)
    for n_chips in (256, 512):
        got = roofline.analytic_floors(cfg, get_shape(shape), n_chips)
        want = ref_roofline.analytic_floors(rcfg, ref_get_shape(shape),
                                            n_chips)
        assert got == want
        assert roofline.model_flops(cfg, get_shape(shape), n_chips) \
            == ref_roofline.model_flops(rcfg, ref_get_shape(shape), n_chips)


@pytest.mark.parametrize("arch,shape", CASES)
def test_roofline_terms_bit_identical(arch, shape):
    """The terms of each case's floors, on the reference's hw and on the
    port's."""
    cfg, _ = configs(arch, shape)
    f = roofline.analytic_floors(cfg, get_shape(shape), 256)
    args = (f["flops_floor"], f["bytes_floor"], f["collective_floor"])
    for hw in (ref_roofline.HW, roofline.HW):
        assert roofline.roofline_terms(*args, hw=hw) \
            == ref_roofline.roofline_terms(*args, hw=hw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_flop_split_bit_identical(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for tp in (1, 2, 4, 8):
        for parallel in ("exact", "efficient"):
            for batch, s_cache in ((8, 4096), (64, 32768)):
                kw = dict(tp=tp, parallel=parallel, batch=batch,
                          s_cache=s_cache)
                assert roofline.decode_flop_split(cfg, **kw) \
                    == ref_roofline.decode_flop_split(rcfg, **kw)


def test_hw_holds_the_h100_figures():
    """NVIDIA's H100 SXM5 datasheet figures and the card's own memory:
    none of the reference's TPU figures."""
    assert roofline.HW["peak_flops"] == 989e12
    assert roofline.HW["hbm_bw"] == 3.35e12
    assert roofline.HW["link_bw"] == 450e9
    # total_memory of an NVIDIA H100 80GB HBM3, as torch reports it
    assert roofline.HW["hbm_bytes"] == 85_017_493_504
    assert set(roofline.HW) == set(ref_roofline.HW)
    for key, value in ref_roofline.HW.items():
        assert roofline.HW[key] != value, key
    assert not hasattr(roofline, "collective_bytes")


def test_default_hw_is_the_cards():
    t = roofline.roofline_terms(989e12, 3.35e12, 450e9)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0,
                 "dominant": "compute"}
