"""Time the split-KV decode kernels, the partial (LSE) paged kernel and
the flash op's short-query path on the card at chip_smoke.py's decode
shapes, tensor-parallel stripes and seamless-m4t-medium's decode-step
cross-attention, for several sub-split sizes (64-row units a sub-split),
through their bindings, as CUDA-graph replays; the ops' choices are
SPLIT_UNITS and LSE_SPLIT_UNITS in
``repro_torch/kernels/decode_attention/ops.py``.

    PYTHONPATH=src python tools/decode_split_tune.py [--units 1 2 3 4 6 8 16]

Prints, per shape, the byte bound and each size's device time and its
largest difference from the plain version.  Needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (BF16_FLOPS, bound_ms, decode_case,  # noqa: E402
                        dense_decode_bytes_flops, dense_decode_case,
                        device_ms, lse_bytes_flops, lse_case,
                        paged_bytes_flops, stripe)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    DENSE_DECODE_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
    split_kv_sub_splits)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_dense_reference, decode_attention_paged_lse_reference,
    decode_attention_paged_reference)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    FLASH_SPLIT_KERNEL)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference)


def launch(kind: str, args, units: int) -> torch.Tensor:
    """One call of the kernel's binding with ``units`` units a sub-split."""
    q = args[0]
    b, h, dh = q.shape if kind != "short" else (q.shape[0], q.shape[2],
                                                 q.shape[3])
    n_rows = (args[1].shape[1] if kind in ("dense", "short")
              else args[3].shape[1] * args[1].shape[1])
    n_sub = split_kv_sub_splits(n_rows, units)
    out = torch.empty_like(q)
    part = torch.empty(max(1, n_sub * b * h * (dh + 2)), device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kind == "short":       # one query a row: (B, 1, H, dh) over k, v
        _, k, v, kpos = args
        qh = q[:, 0].contiguous()
        out = torch.empty_like(qh)
        FLASH_SPLIT_KERNEL(qh.data_ptr(), k.data_ptr(), v.data_ptr(),
                           kpos.data_ptr(), out.data_ptr(), part.data_ptr(),
                           b, qh.shape[1], k.shape[2], qh.shape[2],
                           k.shape[1], units, qh.shape[2] ** -0.5, stream)
        return out[:, None]
    if kind == "lse":
        _, kp, vp, tables, cl = args
        lse = torch.empty(b, h, device=q.device)
        PAGED_LSE_KERNEL(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                         tables.data_ptr(), cl.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), part.data_ptr(), b, h, kp.shape[2],
                         dh, kp.shape[1], tables.shape[1], units, 0,
                         dh ** -0.5, stream)
    elif kind == "paged":
        _, kp, vp, tables, cl = args
        PAGED_DECODE_KERNEL(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                            tables.data_ptr(), cl.data_ptr(), out.data_ptr(),
                            part.data_ptr(), b, h, kp.shape[2], dh,
                            kp.shape[1], tables.shape[1], units, 0,
                            dh ** -0.5, stream)
    else:
        _, k, v, cl = args
        DENSE_DECODE_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            cl.data_ptr(), out.data_ptr(), part.data_ptr(),
                            b, h, k.shape[2], dh, k.shape[1], units,
                            dh ** -0.5, stream)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--units", type=int, nargs="+",
                    default=[1, 2, 3, 4, 6, 8, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    llama = get_config("llama3.2-1b")
    cases = [("paged", f"{c.name} (8 lanes, 2048-token tables)",
              decode_case(c, dev, gen))
             for c in (llama, get_config("zamba2-1.2b"),
                       get_config("nemotron-4-340b"),
                       get_config("granite-34b"))]
    cases += [("dense", name, dense_decode_case(dev, gen, 8, h, kvh, dh,
                                                s_max, hi))
              for name, h, kvh, dh, s_max, hi in (
                  ("llama3.2-1b 8192-slot ring", 32, 8, 64, 8192, 8392),
                  ("MQA", 48, 1, 128, 1024, 1024),
                  ("seamless-m4t-medium", 16, 16, 64, 512, 512),
                  ("nemotron-4-340b", 96, 8, 192, 1024, 1224))]
    for c in (get_config("qwen2-1.5b"), llama, get_config("granite-34b"),
              get_config("nemotron-4-340b")):
        q, kp, vp, tables, cl = lse_case(dev, gen, c.n_heads, c.n_kv_heads,
                                         c.head_dim)
        cases.append(("lse", f"{c.name} stripe 0 of 4 (8 lanes, 32 pages)",
                      (q, kp, vp) + stripe(tables, cl, 0)))
    seam = get_config("seamless-m4t-medium")
    q = torch.randn(8, 1, seam.n_heads, seam.head_dim, generator=gen,
                    device=dev).bfloat16()
    k, v = (torch.randn(8, 4096, seam.n_kv_heads, seam.head_dim,
                        generator=gen, device=dev).bfloat16()
            for _ in range(2))
    cases.append(("short", "seamless-m4t-medium decode-step cross-attention "
                  "(B 8, Sq 1, 4096 frames)",
                  (q, k, v, torch.arange(4096, device=dev,
                                         dtype=torch.int32))))
    print(f"{torch.cuda.get_device_name(0)}; times in ms")
    for kind, name, case in cases:
        q = case[0]
        if kind == "short":
            q, k, v, kpos = case
            want = attention_reference(q, k, v, kpos[-1:], kpos,
                                       causal=False)
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            flops = 4.0 * k.shape[1] * q.shape[0] * q.shape[2] * q.shape[3]
        elif kind == "lse":
            want = decode_attention_paged_lse_reference(*case)[0]
            n_bytes, flops = lse_bytes_flops(q, case[1].shape[2], case[3],
                                             case[4])
        elif kind == "paged":
            want = decode_attention_paged_reference(*case)
            n_bytes, flops = paged_bytes_flops(q, case[1].shape[2], case[3],
                                               case[4])
        else:
            want = decode_attention_dense_reference(*case, window=1)
            n_bytes, flops = dense_decode_bytes_flops(q, case[1], case[3])
        bnd, _ = bound_ms(n_bytes, flops, BF16_FLOPS)
        row = []
        for units in args.units:
            got = launch(kind, case, units)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ms = device_ms(lambda: launch(kind, case, units))
            row.append(f"{units}: {ms:.4f} (err {err:.1e})")
        h, dh = q.shape[-2], q.shape[-1]
        print(f"{kind} {name}, H{h}/KV{case[1].shape[2]}, dh {dh}, bound "
              f"{bnd:.5f}: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
