"""Time the split-KV decode kernels on the card at chip_smoke.py's decode
shapes for several sub-split sizes (64-row units a sub-split), through
their bindings, as CUDA-graph replays; the ops' choice is SPLIT_UNITS
in ``repro_torch/kernels/decode_attention/ops.py``.

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
                        device_ms, paged_bytes_flops)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    DENSE_DECODE_KERNEL, PAGED_DECODE_KERNEL, split_kv_sub_splits)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_dense_reference, decode_attention_paged_reference)


def launch(kind: str, args, units: int) -> torch.Tensor:
    """One call of the kernel's binding with ``units`` units a sub-split."""
    q = args[0]
    b, h, dh = q.shape
    n_rows = (args[3].shape[1] * args[1].shape[1] if kind == "paged"
              else args[1].shape[1])
    n_sub = split_kv_sub_splits(n_rows, units)
    out = torch.empty_like(q)
    part = torch.empty(max(1, n_sub * b * h * (dh + 2)), device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kind == "paged":
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
    print(f"{torch.cuda.get_device_name(0)}; times in ms")
    for kind, name, case in cases:
        q = case[0]
        if kind == "paged":
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
        print(f"{kind} {name}, H{q.shape[1]}/KV{case[1].shape[2]}, dh "
              f"{q.shape[2]}, bound {bnd:.5f}: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
