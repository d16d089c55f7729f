"""The halo-consuming conv K1 against the library conv — the counterpart of
``benchmarks/communication/halo/benchmark_pallas_conv.py``.

Times the margin-consuming VALID conv (the hot op of fused halo-D2 runs,
``ops/d2.py``) three ways at D2-shaped inputs:

  xla_valid — the library conv (``F.conv2d``) VALID on the margin input
              (the JAX tool's name for its library conv is kept)
  pallas    — K1, ``ops/halo_conv.halo_conv2d`` (the hand-written kernel)
  xla_same  — the library conv SAME on the unpadded input (the D1 cost)

and holds K1 against its plain version (``halo_conv2d_plain``: bf16 within
2^-7·max|y|, one bf16 ULP of the largest output, fp32 within 8 scaled ULP)
and against the library conv (rtol/atol 0.05, the JAX tool's check).
Prints one JSON line with the JAX tool's keys: ms and TFLOP/s per variant,
the K1/library speedup and ``"validation": "pass"``.  On the card the times
are device time (CUDA events); ``--device cpu`` runs the plain version and
times the host.

Example (one card):
  python mpi4dl_tpu_torch/benchmarks/communication/halo/benchmark_pallas_conv.py \\
      --height 512 --width 512 --cin 256 --cout 256 --kernel 3 --dtype bf16
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 4)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from mpi4dl_tpu_torch.benchmarks.communication.halo._timing import platform, timed_ms  # noqa: E402
from mpi4dl_tpu_torch.device import resolve_device  # noqa: E402
from mpi4dl_tpu_torch.ops.halo_conv import halo_conv2d, halo_conv2d_plain  # noqa: E402


def conv_flops(n: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int) -> int:
    """MAC-based FLOPs of the VALID conv (2 a MAC; ``pallas_conv.py:388``)."""
    return 2 * n * h * w * cin * cout * kh * kw


def within_plain(got: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype) -> bool:
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    bound = 2.0 ** -7 * scale if dtype == torch.bfloat16 else 8 * 2.0 ** -23 * scale
    return err <= bound


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--cin", type=int, default=256)
    p.add_argument("--cout", type=int, default=256)
    p.add_argument("--kernel", type=int, default=3)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--device", default="cuda", help="cuda (K1) or cpu (its plain version)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    k, h, w = args.kernel, args.height, args.width
    m = k - 1
    rng = np.random.default_rng(0)
    x_pad = torch.from_numpy(rng.standard_normal(
        (args.batch, h + m, w + m, args.cin)).astype(np.float32)).to(dev, dtype)
    x_raw = x_pad[:, m // 2:m // 2 + h, m // 2:m // 2 + w].contiguous()
    wk = (torch.from_numpy(rng.standard_normal((k, k, args.cin, args.cout)).astype(np.float32))
          / (k * k)).to(dev, dtype)
    w_oihw = wk.permute(3, 2, 0, 1).contiguous()
    nchw_pad = x_pad.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    nchw_raw = x_raw.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    variants = {
        "xla_valid": lambda: F.conv2d(nchw_pad, w_oihw),
        "pallas": lambda: halo_conv2d(x_pad, wk),
        "xla_same": lambda: F.conv2d(nchw_raw, w_oihw, padding=m // 2),
    }
    flops = conv_flops(args.batch, h, w, args.cin, args.cout, k, k)
    results = {}
    for name, fn in variants.items():
        ms = timed_ms(fn, dev, args.warmup, args.iterations)
        results[name] = {"ms": round(ms, 4), "tflops": round(flops / (ms * 1e-3) / 1e12, 2)}

    got = halo_conv2d(x_pad, wk)
    plain_ok = within_plain(got, halo_conv2d_plain(x_pad, wk), dtype)
    lib = variants["xla_valid"]().permute(0, 2, 3, 1)
    lib_ok = bool(torch.allclose(got.float(), lib.float(), rtol=0.05, atol=0.05))
    ok = plain_ok and lib_ok
    out = {
        "metric": "halo_valid_conv_ms",
        "value": results["pallas"]["ms"],
        "unit": "ms",
        "config": {"h": h, "w": w, "cin": args.cin, "cout": args.cout, "k": k,
                   "batch": args.batch, "dtype": args.dtype},
        "variants": results,
        "pallas_speedup_vs_xla": round(results["xla_valid"]["ms"] / results["pallas"]["ms"], 3),
        "flops_per_call": flops,
        "validation": "pass" if ok else "FAIL",
        "plain_validation": "pass" if plain_ok else "FAIL",
        "platform": platform(dev),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
