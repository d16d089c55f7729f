"""Drive the PyTorch port (mpi4dl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile out.txt  # also profile one step of each
                                             # slice, tables to out.txt

Phases; any failure ends the run with a non-zero exit and nothing is caught:

1. Build: compile the port's CUDA kernels from ``mpi4dl_tpu_torch/csrc``
   with nvcc (one process per source, all at once); print the build
   seconds and the card's name and power limit; check with ``cuobjdump
   -sass`` that every bf16 halo-conv kernel and every bf16 block-flash
   kernel (K3's forward, its backward's dK/dV and dQ passes) issues
   tensor-core MMAs (HMMA) and, where its copies are 8 or 16 bytes,
   cp.async (LDGSTS).
2. Kernels: hold K1 (halo conv), K2 (fused relu→conv→BN-stats) and K1 as
   the dx of K2's backward against their plain PyTorch versions on the card,
   at the eight shapes of the main path (bf16) and at one fp32 ragged-tail
   shape; two K2 launches must be bitwise equal.  Time kernel, plain
   version and (K1) ``F.conv2d`` on the device: 20 calls in a CUDA graph,
   the median of 5 replays (an eager loop of such calls measures the
   host's launch rate instead; the wrappers' and ``F.conv2d``'s eager
   time per call, median of 5 windows of 20, is printed beside it).  Print
   the kernel/``F.conv2d`` ratio of device times.  TF32 is off.
   Tolerances: fp32 ≤ 8 scaled ULP (the JAX test's metric,
   tests/test_pallas_conv.py:401-453).  bf16: both sides accumulate in fp32
   and round once, so an output may differ by one bf16 ULP where the two
   fp32 sums straddle a rounding boundary: |Δy| ≤ 2^-7·max|y|, and for the
   fp32 statistics of the cast y |Δsum| ≤ 2^-7·Σ|y|, |Δsumsq| ≤ 2^-6·Σy².
3. Slice: full-width AmoebaNet-D(18 layers, 416 filters), 1024², batch 1,
   bf16 compute, fp32 params, SGD lr 1e-3, fused kernels on, remat off:
   1 warm-up and 3 timed steps with finite losses and exactly 80 K2 and 80
   K1 launches per step; img/s and peak memory.  Then AmoebaNet-D(3, 416)
   at 256² from one seed: one step through the kernels and one through the
   plain (unfused, library-conv) path; the losses agree within rtol 1e-2
   (bf16 keeps 8 bits, and the two paths round conv outputs after
   different fp32 summation orders, so one-ULP flips compound over cells).
4. K3 kernels: hold the block-flash kernel against its plain version at
   the kernel registry's two cases, at ``flash_attention_local``'s shapes
   of the long-context slice (B1 H8 D128, T 4096 and 16384, causal, bf16
   q/k/v) and at three ring hops of 4096 (diagonal, past, wholly future)
   in fp32 and in bf16.  bf16 q, k and v take the tensor-core kernel,
   fp32 the CUDA-core one; both are held to m (unmasked rows) and o_hat/l
   within 1e-5·max(1, max|ref|), l within rtol 1e-5, masked rows exactly
   (0, -1e30, 0) (TF32 off for the plain side).  At every bf16 shape K3's
   backward kernel is held against ``block_flash_bwd_plain`` (fp32
   gradients within rtol 1e-4 / atol 1e-5·max|ref|, the JAX gradient
   test's tolerance; zero gradients exactly where every key is masked),
   and two launches of the forward and of the backward are bitwise equal.
   Time kernel, plain version and, at the local shapes,
   ``F.scaled_dot_product_attention`` in fp32 and in bf16 (forward, and
   its backward alone) with CUDA events (median of 5 windows of 10 calls;
   3 of 3 at T 16384).
5. Ring: the one-process emulation of a 4-rank ring (per-hop offsets, K3,
   ``mlo_merge``) at B1 H8 D128 T 16384, causal and not, against plain
   single-device attention (rtol/atol 2e-5, tests/flash_ring_check.py);
   and the same in bf16 (both sides round the output to bf16 once after
   fp32 work in another order: |Δ| ≤ 2^-7·max|ref|, one bf16 ULP of the
   largest output); then the port's ``benchmark_ring_attention`` tool at
   T 16384, whose JSON line must read ``"validation": "pass"``.
6. Long-context slice: four ``SeqBlock(1024, 8 heads, mlp 4, causal)``,
   B1 T 16384, bf16 activations and targets, fp32 params, SGD lr 1e-3,
   through ``make_seq_cp_train_step(group=None)``: 1 warm-up and 3 timed
   steps with finite losses and exactly 4 K3 and 4 K3-backward launches
   per step; tokens/s and peak memory.  Then one block at T 2048, one step
   through K3 and one through the einsum path: in fp32 the losses agree
   within rtol 1e-4; in bf16 within rtol 1e-3, a quarter of one bf16 ULP
   (the two attention paths round their bf16 outputs after different fp32
   summation orders, so some elements differ by one ULP, 2^-8 relative,
   and the loss, a mean over 2M outputs of the block's bf16 layers,
   averages those flips).
7. SP kernels: the spatial-parallel paths' K1/K2 calls, found by a dry run
   of each step on the meta device (``halo_conv.count_dispatches``: the
   port's dispatch at full size, no memory): every distinct shape and
   statistics window held against the plain version (phase 2's bf16
   tolerances, the statistics over the call's window), two launches
   bitwise equal, device time of kernel, plain version and (K1)
   ``F.conv2d``, and the bound; per path, the per-step sums.
8. SP slice: AmoebaNet-D(18, 416), 2048², batch 1, 1000 classes, a 2x2
   square grid of 1024² tiles, halo-D2, fused kernels on, bf16 over fp32
   params, SGD lr 1e-3, remat off, through ``make_spatial_train_step`` on
   the one-process tile grid: 1 warm-up and 3 timed steps with finite
   losses and, each step, exactly the K1/K2 launches of its dry run; img/s,
   peak memory, and the first step's loss (the four-card NCCL runner's
   first step from the same seed is held to it).  Then ResNet-110 v2 at
   1024², same grid and settings: 1 warm-up and 2 timed steps, likewise.
9. SP checks at reduced depth, AmoebaNet-D(3, 416) at 512² on the 2x2
   grid: D2 through the kernels against D2 through the plain path, losses
   within rtol 1e-2 in bf16 (the reason of phase 3) and 1e-5 in fp32
   (tests/test_d2.py); D1 against the single-device step in fp32 over two
   steps, losses within rtol 1e-4 and parameters and running statistics
   within rtol 1e-3 / atol 1e-4 (tests/test_spatial.py).
10. The kernels' JSON line, the card line, and last the result line.  K1's
   and K2's ``launches``, ``ms``, ``plain_ms``, ``library_ms`` and
   ``bound_ms`` are those of the SP AmoebaNet path (phase 8's run, per
   step for the times); ``by_path`` gives per-step launches and times of
   each path (single-card AmoebaNet, SP AmoebaNet, SP ResNet).

Phases 7-9 run between phases 3 and 4.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores (same)
HBM_BYTES_PER_S = 3.35e12

# The main path's K2 / K1-dx calls per training step: (H = W, m = Cin =
# Cout, kernel, calls) at AmoebaNet-D(18, 416), 1024², batch 1.
MAIN_PATH = [
    (256, 52, (1, 7), 1), (256, 52, (7, 1), 1),
    (128, 104, (1, 7), 13), (128, 104, (7, 1), 13),
    (64, 208, (1, 7), 13), (64, 208, (7, 1), 13),
    (32, 416, (1, 7), 13), (32, 416, (7, 1), 13),
]
K1_SRC = "mpi4dl_tpu/ops/pallas_conv.py:41"
K2_SRC = "mpi4dl_tpu/ops/pallas_conv.py:106"
K3_SRC = "mpi4dl_tpu/ops/pallas_attention.py:76"
K3_BWD_SRC = "mpi4dl_tpu/ops/pallas_attention.py:243"
SOURCE = "mpi4dl_tpu_torch/csrc/halo_conv.cu"
K3_SOURCE = "mpi4dl_tpu_torch/csrc/block_flash.cu"

# The long-context slice: SeqBlock(1024, 8 heads) x 4, B1, T 16384 — the JAX
# ring tool's width (benchmarks/communication/ring/benchmark_ring_attention.py
# :38-40).  Each block's forward makes one K3 call at (BH 8, T, T, D 128).
SEQ_T, SEQ_D, SEQ_HEADS, SEQ_BLOCKS = 16384, 1024, 8, 4
# K3 checks: (label, BH, Tq, Tk, D, q/k/v dtype, causal, q_off, k_off,
# library yardstick?).  The first two are the kernel registry's cases
# (mpi4dl_tpu/ops/kernel_registry.py:76-106, scale 0.125).
K3_SHAPES = [
    ("registry fp32", 2, 48, 300, 64, "float32", False, 0, 0, False),
    ("registry bf16 causal", 2, 48, 300, 64, "bfloat16", True, 0, 0, False),
    ("local T=4096", 8, 4096, 4096, 128, "bfloat16", True, 0, 0, True),
    ("local T=16384", 8, SEQ_T, SEQ_T, 128, "bfloat16", True, 0, 0, True),
    ("hop diagonal", 8, 4096, 4096, 128, "float32", True, 4096, 4096, False),
    ("hop past", 8, 4096, 4096, 128, "float32", True, 8192, 0, False),
    ("hop future", 8, 4096, 4096, 128, "float32", True, 0, 4096, False),
    ("hop diagonal bf16", 8, 4096, 4096, 128, "bfloat16", True, 4096, 4096, False),
    ("hop past bf16", 8, 4096, 4096, 128, "bfloat16", True, 8192, 0, False),
    ("hop future bf16", 8, 4096, 4096, 128, "bfloat16", True, 0, 4096, False),
]
K3_MAIN = "local T=16384"   # the slice's K3 call, SEQ_BLOCKS times a step


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` windows of the mean time of ``iters`` calls,
    after two warm-up calls (CUDA events)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 20, windows: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    (after three warm-up calls), the median over ``windows`` replays.  The
    graph leaves out the host's time to launch each call, which bounds an
    eager loop of calls that take tens of microseconds on the card."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def sass_counts(lib) -> dict:
    """Tensor-core (HMMA, HGMMA) and cp.async (LDGSTS) instructions in each
    kernel of a built library, from ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", str(lib)], check=True, capture_output=True,
                         text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0, "LDGSTS": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA", "LDGSTS"):
                if op + "." in line or op + " " in line:
                    counts[fn][op] += 1
                    break
    return counts


def check_flash_sass(lib) -> None:
    """Every bf16 kernel of block_flash.cu (forward, dK/dV and dQ passes)
    issues HMMA, and every one whose copies are 8 or 16 bytes wide issues
    cp.async (LDGSTS)."""
    counts = sass_counts(lib)
    tc = {}
    for name, c in counts.items():
        # template <KD, VEC>
        m = re.search(r"2tc\d+block_flash_(fwd|bwd_kv|bwd_q)_kernelILi\d+ELi(\d+)E", name)
        if m:
            tc[name] = c
            assert c["HMMA"] + c["HGMMA"] > 0, (name, c)
            assert c["LDGSTS"] > 0 or m.group(2) == "1", (name, c)
    assert len(tc) == 18, f"{len(tc)} bf16 block-flash kernels in {lib}"
    hmma = [c["HMMA"] for c in tc.values()]
    print(f"build: block_flash.cu SASS: {len(tc)} bf16 kernels, HMMA {sum(hmma)} "
          f"({min(hmma)}-{max(hmma)} a kernel), LDGSTS "
          f"{sum(c['LDGSTS'] for c in tc.values())}; fp32 kernels HMMA "
          f"{sum(c['HMMA'] for k, c in counts.items() if k not in tc)}", flush=True)


def check_sass(lib) -> None:
    """Every bf16 kernel of halo_conv.cu issues HMMA, and every one whose
    copies are 8 or 16 bytes wide issues cp.async (LDGSTS)."""
    counts = sass_counts(lib)
    tc = {}
    for name, c in counts.items():
        # template <WARPS_M, WARPS_N, MI, NI, KS, VEC, Tout>
        m = re.search(r"2tc16halo_conv_kernelI(?:Li\d+E){5}Li(\d+)E", name)
        if m:
            tc[name] = c
            assert c["HMMA"] + c["HGMMA"] > 0, (name, c)
            assert c["LDGSTS"] > 0 or m.group(1) == "1", (name, c)
    assert tc, f"no tensor-core kernel in {lib}"
    hmma = [c["HMMA"] for c in tc.values()]
    print(f"build: halo_conv.cu SASS: {len(tc)} bf16 kernels, HMMA {sum(hmma)} "
          f"({min(hmma)}-{max(hmma)} a kernel), HGMMA "
          f"{sum(c['HGMMA'] for c in tc.values())}, LDGSTS "
          f"{sum(c['LDGSTS'] for c in tc.values())}; fp32 kernels HMMA "
          f"{sum(c['HMMA'] for k, c in counts.items() if k not in tc)}", flush=True)


def scaled_ulp(got, ref) -> float:
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    assert scale > 0
    return float((got - ref).abs().max()) / (2.0 ** -23 * scale)


def check_bf16(name, got, ref) -> float:
    err = float((got.float() - ref.float()).abs().max())
    bound = 2.0 ** -7 * float(ref.float().abs().max())
    assert err <= bound, f"{name}: |err| {err} > {bound}"
    return err


def check_stats_bf16(name, s, ss, s_ref, ss_ref, y_ref) -> None:
    yw = y_ref.float()
    es = float((s - s_ref).abs().max())
    ess = float((ss - ss_ref).abs().max())
    bs = 2.0 ** -7 * float(yw.abs().sum(dim=(0, 1, 2)).max())
    bss = 2.0 ** -6 * float((yw * yw).sum(dim=(0, 1, 2)).max())
    assert es <= bs, f"{name} sum: {es} > {bs}"
    assert ess <= bss, f"{name} sumsq: {ess} > {bss}"


def reset_all_counts() -> None:
    from mpi4dl_tpu_torch.ops import flash_attention as fa
    from mpi4dl_tpu_torch.ops import halo_conv as hc

    hc.reset_launch_counts()
    fa.reset_launch_counts()


def call_cost(x, w, y_shape, stats: bool):
    """(bytes, flops) of one call: each input read once, each output written
    once; 2 flops per multiply-add."""
    n, h, wd, cout = y_shape
    kh, kw, cin, _ = w.shape
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + n * h * wd * cout * x.element_size() + (8 * cout if stats else 0))
    return nbytes, 2 * n * h * wd * cin * cout * kh * kw


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from mpi4dl_tpu_torch.ops import halo_conv as hc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16

    # fp32 ragged tails: the kernel registry's conv case.
    x = torch.randn((1, 130, 258, 8), generator=gen, device=dev)
    w = torch.randn((3, 3, 8, 300), generator=gen, device=dev) / 9
    win = (1, 127, 2, 254)
    got = hc.halo_conv2d(x, w, fuse_relu=True, stat_window=win)
    ref = hc.halo_conv2d_plain(x, w, fuse_relu=True, stat_window=win)
    for name, g, r in zip(("y", "sum", "sumsq"), got, ref):
        u = scaled_ulp(g, r)
        assert u <= 8.0, f"K2 fp32 ragged {name}: {u} scaled ULP"
    u = scaled_ulp(hc.halo_conv2d(x, w), hc.halo_conv2d_plain(x, w))
    assert u <= 8.0, f"K1 fp32 ragged: {u} scaled ULP"
    torch.cuda.synchronize()
    print("kernels: fp32 ragged (1,130,258,8) x (3,3,8,300): K1, K2 within 8 scaled ULP",
          flush=True)

    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0, err=0.0)
           for k in ("K1", "K2")}
    for hw, m, (kh, kw), calls in MAIN_PATH:
        tag = f"{hw}x{hw} m={m} {kh}x{kw}"
        bound = 1.0 / math.sqrt(m * kh * kw)
        xp = torch.randn((1, hw + kh - 1, hw + kw - 1, m), generator=gen, device=dev).to(bf)
        wk = ((torch.rand((kh, kw, m, m), generator=gen, device=dev) * 2 - 1) * bound).to(bf)
        full = (0, hw, 0, hw)
        # K2 as the forward of a fused window.
        y, s, ss = hc.halo_conv2d(xp, wk, fuse_relu=True, stat_window=full)
        yr, sr, ssr = hc.halo_conv2d_plain(xp, wk, fuse_relu=True, stat_window=full)
        e2 = check_bf16(f"K2 {tag} y", y, yr)
        check_stats_bf16(f"K2 {tag}", s, ss, sr, ssr, yr)
        again = hc.halo_conv2d(xp, wk, fuse_relu=True, stat_window=full)
        assert all(torch.equal(a, b) for a, b in zip((y, s, ss), again)), \
            f"K2 {tag}: two launches differ"
        # K1 as the forward conv, and as K2's dx: the padded cotangent with
        # the flipped, io-swapped kernel.
        e1 = check_bf16(f"K1 {tag} fwd", hc.halo_conv2d(xp, wk), hc.halo_conv2d_plain(xp, wk))
        ct = torch.randn((1, hw, hw, m), generator=gen, device=dev).to(bf)
        ctp = hc.pad_hw(ct, kh - 1, kw - 1)
        wt = hc._flip_swap(wk)
        dx = hc.halo_conv2d(ctp, wt)
        e1 = max(e1, check_bf16(f"K1 {tag} dx", dx, hc.halo_conv2d_plain(ctp, wt)))
        torch.cuda.synchronize()
        def k2_fn():
            return hc.halo_conv2d(xp, wk, fuse_relu=True, stat_window=full)

        def k1_fn():
            return hc.halo_conv2d(ctp, wt)

        ctp_nchw, wt_oihw = ctp.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
        k2 = graph_ms(k2_fn)
        p2 = graph_ms(lambda: hc.halo_conv2d_plain(xp, wk, fuse_relu=True, stat_window=full))
        k1 = graph_ms(k1_fn)
        l1 = graph_ms(lambda: F.conv2d(ctp_nchw, wt_oihw))
        p1 = graph_ms(lambda: hc.halo_conv2d_plain(ctp, wt))
        eager = {"K2": time_ms(k2_fn), "K1": time_ms(k1_fn),
                 "F.conv2d": time_ms(lambda: F.conv2d(ctp_nchw, wt_oihw))}
        b2, f2 = call_cost(xp, wk, y.shape, True)
        b1, f1 = call_cost(ctp, wt, dx.shape, False)
        for key, ms, pms, lms, nb, fl, err in (("K2", k2, p2, 0.0, b2, f2, e2),
                                               ("K1", k1, p1, l1, b1, f1, e1)):
            t = tot[key]
            t["ms"] += calls * ms
            t["plain_ms"] += calls * pms
            t["library_ms"] += calls * lms
            t["bytes"] += calls * nb
            t["flops"] += calls * fl
            t["err"] = max(t["err"], err)
            bound_us = 1e6 * max(nb / HBM_BYTES_PER_S, fl / PEAK_BF16_FLOPS)
            lib = (f" F.conv2d {lms:.4f} ms (eager {eager['F.conv2d']:.4f}; "
                   f"kernel/F.conv2d {ms / lms:.2f})" if key == "K1" else "")
            print(f"kernels: {key} {tag} x{calls}/step: kernel {ms:.4f} ms (eager "
                  f"{eager[key]:.4f})  plain {pms:.4f} ms{lib}  bound {bound_us:.2f} us  "
                  f"{fl / ms / 1e9:.1f} TFLOP/s  max|err| {err:.3g}", flush=True)
    return tot


def phase_slice():
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.ops import halo_conv as hc
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    dev = torch.device("cuda")
    shape = (1, 1024, 1024, 3)
    model = amoebanetd(shape, num_classes=1000, num_layers=18, num_filters=416,
                       device=dev, seed=0)
    opt = Optimizer("sgd", lr=1e-3)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16, remat=False,
                           pallas_conv=True)
    state = TrainState.create(model, opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(shape, generator=gen, device=dev)
    y = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    times = []
    for i in range(4):
        before = dict(hc.LAUNCHES)
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        d2 = hc.LAUNCHES["halo_conv2d_stats"] - before["halo_conv2d_stats"]
        d1 = hc.LAUNCHES["halo_conv2d"] - before["halo_conv2d"]
        print(f"slice: step {i} loss {loss:.6f} {times[-1] * 1e3:.1f} ms "
              f"K2 {d2} K1 {d1} launches", flush=True)
        assert math.isfinite(loss), f"step {i}: loss {loss}"
        assert d2 == 80 and d1 == 80, f"step {i}: K2 {d2}, K1 {d1} launches (want 80, 80)"
    launches = dict(hc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ips = 3 / sum(times[1:])
    print(f"slice: AmoebaNet-D(18,416) 1024^2 bs1 bf16: {ips:.3f} img/s "
          f"({1e3 * sum(times[1:]) / 3:.1f} ms/step), peak {peak / 2**30:.2f} GiB",
          flush=True)
    del model, state, step, opt
    torch.cuda.empty_cache()

    # Reduced depth: the kernels against the plain (unfused) path.
    small = (1, 256, 256, 3)
    xs = torch.randn(small, generator=gen, device=dev)
    ys = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    losses = []
    for fused in (True, False):
        mdl = amoebanetd(small, num_classes=1000, num_layers=3, num_filters=416,
                         device=dev, seed=0)
        o = Optimizer("sgd", lr=1e-3)
        st = make_train_step(mdl, o, compute_dtype=torch.bfloat16, pallas_conv=fused)
        _, mm = st(TrainState.create(mdl, o), xs, ys)
        losses.append(float(mm["loss"]))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"slice: AmoebaNet-D(3,416) 256^2 bf16 loss kernels {losses[0]:.6f} "
          f"plain {losses[1]:.6f} rel {rel:.2e}", flush=True)
    assert all(math.isfinite(v) for v in losses), losses
    assert rel <= 1e-2, f"fused vs plain loss rel {rel}"
    return launches


# The spatial-parallel slice: the reference's best published run, "SP square
# + halo-D2" (README "Measured"), at full width on the one-process 2x2 tile
# grid, and ResNet-110 v2 (bench.py:153-163) beside it.
SP_AMOEBA = dict(arch="amoebanet", image=2048, depth=18)
SP_RESNET = dict(arch="resnet", image=1024, depth=110)
SP_PATHS = {"amoebanet_2048_sp_d2": SP_AMOEBA, "resnet110_1024_sp_d2": SP_RESNET}


def sp_parts(dev, arch, image, depth, d2=True, pallas=True, dtype=None):
    """(model, step, state) of an SP training step on a 2x2 square grid of
    tiles in this process: 416 filters (AmoebaNet), 1000 classes, batch 1,
    SGD lr 1e-3, remat off, bf16 compute unless ``dtype`` says otherwise,
    weights from seed 0 (the SP runners' ``--seed`` default)."""
    import torch

    from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for
    from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

    shape = (1, image, image, 3)
    if arch == "amoebanet":
        model = amoebanetd(shape, num_classes=1000, num_layers=depth,
                           num_filters=416, device=dev, seed=0)
    else:
        model = get_resnet_v2(shape, depth, 1000, device=dev, seed=0)
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=d2,
                         use_pallas_conv=pallas)
    opt = Optimizer("sgd", lr=1e-3)
    step = make_spatial_train_step(model, opt, sp,
                                   compute_dtype=dtype or torch.bfloat16)
    return model, step, TrainState.create(model, opt)


def sp_batch(dev, image):
    """The SP runners' synthetic batch for --seed 0 (seed 1, image then label)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((1, image, image, 3), generator=gen, device=dev)
    return x, torch.randint(0, 1000, (1,), generator=gen, device=dev)


def sp_dry_run(arch, image, depth, **kw):
    """The K1/K2 calls of one SP step as the port dispatches them: the
    step on the meta device (shapes only), each call recorded
    (``halo_conv.count_dispatches``)."""
    import warnings

    import torch

    from mpi4dl_tpu_torch.ops import halo_conv as hc

    meta = torch.device("meta")
    _, step, state = sp_parts(meta, arch, image, depth, **kw)
    with warnings.catch_warnings(), hc.count_dispatches() as seen:
        warnings.simplefilter("ignore")
        step(state, torch.zeros((1, image, image, 3), device=meta),
             torch.zeros((1,), dtype=torch.long, device=meta))
    return seen


def phase_sp_kernels(paths):
    """K1 and K2 at every distinct shape that the SP paths' dry runs
    record (``paths``: name -> Dispatches): held against the plain version
    (bf16 tolerances of phase 2, statistics over the call's window), two
    launches bitwise equal, and device time of kernel, plain version and
    (K1) ``F.conv2d``.  Returns per path the per-step sums."""
    import collections

    import torch
    import torch.nn.functional as F

    from mpi4dl_tpu_torch.ops import halo_conv as hc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bf = torch.bfloat16
    uses = collections.defaultdict(collections.Counter)
    for name, seen in paths.items():
        for call in seen.calls:
            kernel, phase, xs, ws, _, relu, win = call
            uses[(kernel, xs, ws, relu, win)][(name, phase)] += 1
    per = {}
    for key, by_path in uses.items():
        kernel, xs, ws, relu, win = key
        kh, kw, cin, cout = ws
        x = torch.randn(xs, generator=gen, device=dev).to(bf)
        w = ((torch.rand(ws, generator=gen, device=dev) * 2 - 1)
             / math.sqrt(cin * kh * kw)).to(bf)
        got = hc.halo_conv2d(x, w, fuse_relu=relu, stat_window=win)
        ref = hc.halo_conv2d_plain(x, w, fuse_relu=relu, stat_window=win)
        tag = f"{kernel} x{tuple(xs)} w{tuple(ws)} win {win}"
        if win is None:
            y, yr = got, ref
        else:
            (y, s, ss), (yr, sr, ssr) = got, ref
            h0, h1, w0, w1 = win
            check_stats_bf16(tag, s, ss, sr, ssr, yr[:, h0:h1, w0:w1])
        err = check_bf16(tag, y, yr)
        again = hc.halo_conv2d(x, w, fuse_relu=relu, stat_window=win)
        same = (torch.equal(y, again) if win is None
                else all(torch.equal(a, b) for a, b in zip(got, again)))
        assert same, f"{tag}: two launches differ"
        torch.cuda.synchronize()
        del got, ref, again
        iters = 20 if x.numel() * 4 <= (64 << 20) else 5
        k_ms = graph_ms(lambda: hc.halo_conv2d(x, w, fuse_relu=relu, stat_window=win), iters)
        p_ms = graph_ms(lambda: hc.halo_conv2d_plain(x, w, fuse_relu=relu,
                                                     stat_window=win), iters)
        l_ms = None
        if win is None and not relu:
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
            l_ms = graph_ms(lambda: F.conv2d(x_nchw, w_oihw), iters)
        nb, fl = call_cost(x, w, y.shape, win is not None)
        per[key] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bytes=nb, flops=fl, err=err)
        bound_us = 1e6 * max(nb / HBM_BYTES_PER_S, fl / PEAK_BF16_FLOPS)
        lib = f"  F.conv2d {l_ms:.4f} ms" if l_ms is not None else ""
        print(f"sp kernels: {tag} {dict(by_path)}: kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.4f} ms{lib}  bound {bound_us:.2f} us  "
              f"{fl / k_ms / 1e9:.1f} TFLOP/s  max|err| {err:.3g}", flush=True)
        del x, w, y, yr
        torch.cuda.empty_cache()
    sums = {}
    for name, seen in paths.items():
        sums[name] = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0,
                              err=0.0, launches=0) for k in ("K1", "K2")}
        for key, by_path in uses.items():
            n = sum(c for (pth, _), c in by_path.items() if pth == name)
            if not n:
                continue
            t = sums[name]["K1" if key[0] == "halo_conv2d" else "K2"]
            m = per[key]
            for f in ("ms", "plain_ms", "bytes", "flops"):
                t[f] += n * m[f]
            t["library_ms"] = (None if t["library_ms"] is None or m["library_ms"] is None
                               else t["library_ms"] + n * m["library_ms"])
            t["err"] = max(t["err"], m["err"])
            t["launches"] += n
        for k, t in sums[name].items():
            print(f"sp kernels: {name} {k}: {t['launches']} launches a step, kernel "
                  f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, F.conv2d "
                  f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 3)}"
                  f" ms, bound {bound_of(t['bytes'], t['flops'], PEAK_BF16_FLOPS)[0]:.3f}"
                  " ms a step", flush=True)
    return sums


def sp_train(dev, parts, pred, steps, label):
    """Drive an SP step ``steps`` times (the first a warm-up) from the
    counts' zero, holding each step's K1/K2 launches to the dry run's
    ``pred``; returns (losses, seconds per timed step, peak bytes,
    launches)."""
    import torch

    from mpi4dl_tpu_torch.ops import halo_conv as hc

    model, step, state = parts
    x, y = sp_batch(dev, model.in_shape[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    losses, times = [], []
    for i in range(steps):
        before = dict(hc.LAUNCHES)
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = {k: hc.LAUNCHES[k] - before[k] for k in hc.LAUNCHES}
        print(f"{label}: step {i} loss {losses[-1]:.6f} {times[-1] * 1e3:.1f} ms "
              f"K2 {got['halo_conv2d_stats']} K1 {got['halo_conv2d']} launches", flush=True)
        assert math.isfinite(losses[-1]), f"step {i}: loss {losses[-1]}"
        assert got == pred.counts, f"step {i}: launches {got}, dispatch predicts {pred.counts}"
    return losses, times[1:], torch.cuda.max_memory_allocated(), dict(hc.LAUNCHES)


def phase_sp_slice(preds):
    """The full-width SP AmoebaNet-D step and the ResNet-110 v2 SP step."""
    import torch

    dev = torch.device("cuda")
    out = {}
    for name, cfg, steps in (("amoebanet_2048_sp_d2", SP_AMOEBA, 4),
                             ("resnet110_1024_sp_d2", SP_RESNET, 3)):
        parts = sp_parts(dev, cfg["arch"], cfg["image"], cfg["depth"])
        losses, times, peak, launches = sp_train(dev, parts, preds[name], steps, name)
        ips = len(times) / sum(times)
        print(f"sp slice: {name} bs1 bf16 2x2 D2: {ips:.3f} img/s "
              f"({1e3 * sum(times) / len(times):.1f} ms/step), peak {peak / 2**30:.2f} GiB, "
              f"first-step loss {losses[0]:.6f}", flush=True)
        out[name] = launches
        del parts
        torch.cuda.empty_cache()
    return out


def phase_sp_checks():
    """Reduced depth on the card: SP D2 through the kernels against SP D2
    through the plain path (bf16 rtol 1e-2, fp32 rtol 1e-5); SP D1 against
    the single-device step in fp32 (tests/test_spatial.py's tolerances)."""
    import warnings

    import torch

    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    warnings.simplefilter("ignore")  # the pad-once pool notice
    dev = torch.device("cuda")
    x, y = sp_batch(dev, 512)
    for dtype, rtol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        losses = []
        for pallas in (True, False):
            _, step, state = sp_parts(dev, "amoebanet", 512, 3, pallas=pallas, dtype=dtype)
            losses.append(float(step(state, x, y)[1]["loss"]))
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"sp checks: AmoebaNet-D(3,416) 512^2 2x2 D2 {dtype}: loss kernels "
              f"{losses[0]:.6f} plain {losses[1]:.6f} rel {rel:.2e}", flush=True)
        assert all(math.isfinite(v) for v in losses) and rel <= rtol, (losses, rtol)
    models, steps, states = [], [], []
    for sp in (False, True):
        if sp:
            mdl, st, state = sp_parts(dev, "amoebanet", 512, 3, d2=False,
                                      dtype=torch.float32)
        else:
            mdl = amoebanetd((1, 512, 512, 3), num_classes=1000, num_layers=3,
                             num_filters=416, device=dev, seed=0)
            opt = Optimizer("sgd", lr=1e-3)
            st = make_train_step(mdl, opt, pallas_conv=True)
            state = TrainState.create(mdl, opt)
        models.append(mdl)
        steps.append(st)
        states.append(state)
    for i in range(2):
        l = [float(steps[j](states[j], x, y)[1]["loss"]) for j in range(2)]
        print(f"sp checks: AmoebaNet-D(3,416) 512^2 fp32 step {i}: one card {l[0]:.7f}, "
              f"SP D1 2x2 {l[1]:.7f}", flush=True)
        assert abs(l[1] - l[0]) <= 1e-4 * abs(l[0]), l
    worst = 0.0
    for a, b in zip(models[0].state_dict().values(), models[1].state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-4)
        worst = max(worst, float((b - a).abs().max()))
    print(f"sp checks: SP D1 vs one card after 2 steps: max|Δ| {worst:.3g} over "
          "parameters and running statistics (rtol 1e-3, atol 1e-4)", flush=True)
    del models, steps, states
    torch.cuda.empty_cache()


def flash_pairs(t_q: int, t_k: int, q_off: int, k_off: int, causal: bool) -> int:
    """The (query, key) pairs a block's mask leaves visible: the work this
    call's data needs."""
    if not causal:
        return t_q * t_k
    return sum(min(t_k, max(0, q_off + i - k_off + 1)) for i in range(t_q))


def flash_cost(bh, t_q, t_k, d, q_bytes, kv_bytes, q_off, k_off, causal):
    """(bytes, flops) of one K3 call: q (bf16 on the tensor-core path, fp32
    scaled on the CUDA-core one) and k, v read once, o_hat, m, l written
    once; 2 matmuls x 2 flops per visible pair and D."""
    nbytes = bh * t_q * d * q_bytes + 2 * bh * t_k * d * kv_bytes + bh * t_q * (d + 2) * 4
    return nbytes, 4 * bh * d * flash_pairs(t_q, t_k, q_off, k_off, causal)


def flash_bwd_cost(bh, t_q, t_k, d, q_off, k_off, causal):
    """(bytes, flops) of one K3 backward call (bf16 q, k, v): q, k, v, dô
    (fp32), m and dl read once, dq, dk, dv (fp32) written once; 5 matmuls
    (s, dP, dv, dk, dq) x 2 flops per visible pair and D."""
    nbytes = (bh * t_q * d * (2 + 4 + 4) + 2 * bh * t_k * d * (2 + 4)
              + 2 * bh * t_q * 4)
    return nbytes, 10 * bh * d * flash_pairs(t_q, t_k, q_off, k_off, causal)


def bound_of(nbytes, flops, peak):
    """(ms, 'bytes' or 'operations'): the larger of bytes over the memory
    rate and flops over ``peak``."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b > t_o else "operations"


def check_flash_bwd(name, got, ref):
    """fp32 gradients within rtol 1e-4 / atol 1e-5·max|ref| (the JAX
    gradient test's tolerance, tests/test_pallas_attention.py:92-108); a
    zero reference exactly.  Returns max|Δ| and the largest share of its
    allowance that an element uses."""
    err = share = 0.0
    for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
        big = float(r.abs().max())
        if big == 0.0:
            assert bool((g == 0).all()), f"{name} {g_name}: not zero"
            continue
        diff = (g - r).abs()
        used = float((diff / (1e-5 * big + 1e-4 * r.abs())).max())
        assert used <= 1.0, f"{name} {g_name}: {used:.3g} of the allowance"
        err, share = max(err, float(diff.max())), max(share, used)
    return err, share


def check_flash(name, got, ref, bound: float = 1e-5) -> float:
    """m (unmasked rows) and o_hat/l within bound·max(1, max|ref|), l within
    rtol bound, masked rows exactly (0, -1e30, 0); returns max|Δ(o_hat/l)|."""
    import torch

    from mpi4dl_tpu_torch.ops.flash_attention import NEG_INF

    (o, m, l), (ro, rm, rl) = got, ref
    live = rm > NEG_INF * 0.5
    assert torch.equal(live, m > NEG_INF * 0.5), f"{name}: masked rows differ"
    dead = ~live
    assert bool(torch.all(m[dead] == NEG_INF) and torch.all(l[dead] == 0)
                and torch.all(o[dead] == 0)), f"{name}: masked rows not (0, -1e30, 0)"
    if not bool(live.any()):
        return 0.0
    dm = float((m[live] - rm[live]).abs().max())
    assert dm <= bound * max(1.0, float(rm[live].abs().max())), f"{name}: |dm| {dm}"
    dl = float(((l - rl).abs() / rl)[live].max())
    assert dl <= bound, f"{name}: l rel {dl}"
    on = o / l.clamp_min(1e-30)[..., None]
    ron = ro / rl.clamp_min(1e-30)[..., None]
    do = float((on - ron).abs().max())
    assert do <= bound * max(1.0, float(ron.abs().max())), f"{name}: |d(o/l)| {do}"
    return do


def sdpa_ms(q, k, v, causal, dtype, iters, windows):
    """``F.scaled_dot_product_attention`` in ``dtype`` on the block's
    ``[BH, T, D]`` tensors: (forward ms, backward-alone ms).  The backward
    is timed as ``torch.autograd.grad`` of one retained forward."""
    import torch
    import torch.nn.functional as F

    bh, _, d = q.shape
    q4, k4, v4 = (x.to(dtype).reshape(1, bh, -1, d).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
                      iters, windows)
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    g = torch.randn_like(out)
    bwd = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), g, retain_graph=True),
                  iters, windows)
    return fwd, bwd


def phase_flash_kernels():
    import torch

    from mpi4dl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    main, main_bwd = {}, {}
    err = err_bwd = 0.0
    for label, bh, tq, tk, d, dt, causal, q_off, k_off, lib in K3_SHAPES:
        dtype = getattr(torch, dt)
        tensor_cores = dtype == torch.bfloat16
        q = torch.randn((bh, tq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((bh, tk, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        scale = 0.125 if label.startswith("registry") else d ** -0.5
        args = (q_off, k_off, causal, scale)
        got = fa.block_flash(q, k, v, *args)
        e = check_flash(f"K3 {label}", got, fa.block_flash_plain(q, k, v, *args))
        assert all(torch.equal(a, b) for a, b in zip(got, fa.block_flash(q, k, v, *args))), \
            f"K3 {label}: two launches differ"
        err = max(err, e)
        iters, windows = (3, 3) if tq > 4096 else (10, 5)
        eb = None
        if tensor_cores:
            do = torch.randn((bh, tq, d), generator=gen, device=dev)
            dl = torch.randn((bh, tq), generator=gen, device=dev)
            bargs = (q, k, v, got[1], do, dl, *args)
            grads = fa.block_flash_bwd(*bargs)
            eb, share = check_flash_bwd(f"K3 bwd {label}", grads,
                                        fa.block_flash_bwd_plain(*bargs))
            assert all(torch.equal(a, b) for a, b in zip(grads, fa.block_flash_bwd(*bargs))), \
                f"K3 bwd {label}: two launches differ"
            err_bwd = max(err_bwd, eb)
            del grads
        del got
        torch.cuda.synchronize()
        ms = time_ms(lambda: fa.block_flash(q, k, v, *args), iters, windows)
        pms = time_ms(lambda: fa.block_flash_plain(q, k, v, *args), iters, windows)
        nb, fl = flash_cost(bh, tq, tk, d, 2 if tensor_cores else 4, k.element_size(),
                            q_off, k_off, causal)
        peak = PEAK_BF16_FLOPS if tensor_cores else PEAK_FP32_FLOPS
        bound_ms, bound_by = bound_of(nb, fl, peak)
        lib_txt, sdpa = "", {}
        if lib:
            for name, ldt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                sdpa[name] = sdpa_ms(q, k, v, causal, ldt, iters, windows)
            lib_txt = "".join(f"  SDPA {n} fwd {f:.4f} bwd {b:.4f} ms"
                              for n, (f, b) in sdpa.items())
        tflops = f"{fl / ms / 1e9:.2f} TFLOP/s" if fl else "no visible pair"
        print(f"kernels: K3 {label} q{(bh, tq, d)} k{(bh, tk, d)} {dt} causal={causal} "
              f"offs=({q_off},{k_off}) {'tensor cores' if tensor_cores else 'CUDA cores'}: "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms{lib_txt}  bound {bound_ms:.4f} ms "
              f"({bound_by}, {peak / 1e12:.0f} TFLOP/s)  {tflops}  max|d(o/l)| {e:.3g}",
              flush=True)
        if label == K3_MAIN:
            main = dict(ms=SEQ_BLOCKS * ms, plain_ms=SEQ_BLOCKS * pms,
                        library_ms=SEQ_BLOCKS * sdpa["bf16"][0], bytes=SEQ_BLOCKS * nb,
                        flops=SEQ_BLOCKS * fl)
        if tensor_cores:
            bms = time_ms(lambda: fa.block_flash_bwd(*bargs), iters, windows)
            bpms = time_ms(lambda: fa.block_flash_bwd_plain(*bargs), iters, windows)
            nbb, flb = flash_bwd_cost(bh, tq, tk, d, q_off, k_off, causal)
            bbound, bby = bound_of(nbb, flb, PEAK_BF16_FLOPS)
            blib = (f"  SDPA bf16 bwd {sdpa['bf16'][1]:.4f} ms  fp32 bwd "
                    f"{sdpa['fp32'][1]:.4f} ms" if lib else "")
            btf = f"{flb / bms / 1e9:.2f} TFLOP/s" if flb else "no visible pair"
            print(f"kernels: K3 bwd {label}: kernel {bms:.4f} ms  plain {bpms:.4f} ms{blib}"
                  f"  bound {bbound:.4f} ms ({bby}, 989 TFLOP/s)  {btf}  max|d grad| "
                  f"{eb:.3g} ({share:.2f} of the allowance)", flush=True)
            if label == K3_MAIN:
                main_bwd = dict(ms=SEQ_BLOCKS * bms, plain_ms=SEQ_BLOCKS * bpms,
                                library_ms=SEQ_BLOCKS * sdpa["bf16"][1],
                                bytes=SEQ_BLOCKS * nbb, flops=SEQ_BLOCKS * flb)
            del bargs, do, dl
        del q, k, v
        torch.cuda.empty_cache()
    main["err"], main_bwd["err"] = err, err_bwd
    return main, main_bwd


def phase_ring():
    import torch

    from mpi4dl_tpu_torch.benchmarks.communication.ring import (
        benchmark_ring_attention as tool,
    )
    from mpi4dl_tpu_torch.ops.ring import emulated_ring, ring_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    q, k, v = (torch.randn((1, SEQ_T, SEQ_HEADS, 128), generator=gen, device=dev)
               for _ in range(3))
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            for causal in (False, True):
                got = emulated_ring(qd, kd, vd, 4, causal)
                want = ring_attention(qd, kd, vd, None, 1, causal=causal, use_flash=False)
                err = float((got.float() - want.float()).abs().max())
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
                else:   # one bf16 ULP of the largest output
                    assert err <= 2.0 ** -7 * float(want.float().abs().max()), err
                print(f"ring: emulated 4-rank ring through K3, B1 H8 D128 T {SEQ_T} "
                      f"{dtype} causal={causal}: max|err| {err:.3g} vs plain attention",
                      flush=True)
                del got, want
            del qd, kd, vd
    del q, k, v
    torch.cuda.empty_cache()
    out = tool.measure(tool.get_parser().parse_args(
        ["--seq-len", str(SEQ_T), "--iterations", "3"]))
    print(json.dumps(out), flush=True)
    assert out["validation"] == "pass", out


def seq_blocks(n: int, dev):
    import torch

    from mpi4dl_tpu_torch.models.seqblock import SeqBlock

    return torch.nn.ModuleList(SeqBlock(SEQ_D, SEQ_HEADS, mlp_ratio=4, causal=True,
                                        device=dev, seed=i) for i in range(n))


def phase_seq_slice():
    import torch

    from mpi4dl_tpu_torch.models.seqblock import make_seq_cp_train_step
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    blocks = seq_blocks(SEQ_BLOCKS, dev)
    step = make_seq_cp_train_step(blocks, None, 1, 1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x, y = (torch.randn((1, SEQ_T, SEQ_D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    times = []
    for i in range(4):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        loss = float(step(x, y))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        d3 = fa.LAUNCHES["block_flash"] - before["block_flash"]
        d3b = fa.LAUNCHES["block_flash_bwd"] - before["block_flash_bwd"]
        print(f"seq slice: step {i} loss {loss:.6f} {times[-1] * 1e3:.1f} ms "
              f"K3 {d3} K3-backward {d3b} launches", flush=True)
        assert math.isfinite(loss), f"step {i}: loss {loss}"
        assert d3 == d3b == SEQ_BLOCKS, \
            f"step {i}: {d3} K3, {d3b} K3-backward launches (want {SEQ_BLOCKS})"
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times[1:]) / 3
    print(f"seq slice: SeqBlock(1024, 8) x{SEQ_BLOCKS} T {SEQ_T} bs1 bf16: "
          f"{SEQ_T / step_s:.1f} tokens/s ({1e3 * step_s:.1f} ms/step), "
          f"peak {peak / 2**30:.2f} GiB", flush=True)
    del blocks, step, x, y
    torch.cuda.empty_cache()

    # Reduced depth: one block at T 2048, K3 against the einsum path, in
    # fp32 (K3 on the CUDA cores, PyTorch-op backward) and in bf16 (K3 and
    # its backward kernel).
    xs, ys = (torch.randn((1, 2048, SEQ_D), generator=gen, device=dev) for _ in range(2))
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        losses = []
        for flash in (True, False):
            st = make_seq_cp_train_step(seq_blocks(1, dev), None, 1, 1e-3, use_flash=flash)
            before = dict(fa.LAUNCHES)
            losses.append(float(st(xs.to(dtype), ys.to(dtype))))
            assert fa.LAUNCHES["block_flash"] - before["block_flash"] == int(flash), "K3"
            want_bwd = int(flash and dtype == torch.bfloat16)
            assert fa.LAUNCHES["block_flash_bwd"] - before["block_flash_bwd"] == want_bwd
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"seq slice: SeqBlock(1024, 8) x1 T 2048 {dtype} loss K3 {losses[0]:.8f} "
              f"einsum {losses[1]:.8f} rel {rel:.2e} (rtol {rtol:g})", flush=True)
        assert all(math.isfinite(v) for v in losses), losses
        assert rel <= rtol, f"K3 vs einsum loss rel {rel}"
    return launches


def _profile(path: str, title: str, step, kernel_keys) -> None:
    """Profile one call of ``step`` (after two warm-ups): device time by
    kernel name, appended to ``path``, and the share of the kernels whose
    names hold each of ``kernel_keys``."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=40)
    # Kernel time only, as the table's own total counts it: CUDA events
    # that are not annotation ranges.
    kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(f"== {title}\n{table}\n")
    print(table, flush=True)
    shares = []
    for key in kernel_keys:
        key_us = sum(e.self_device_time_total for e in kernels if key in e.key)
        shares.append(f"{key} {key_us / 1e3:.1f} ms "
                      f"({100 * key_us / max(busy_us, 1e-9):.1f}% of busy)")
    print(f"profile: {title}: step {wall_us / 1e3:.1f} ms wall, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          + ", ".join(shares), flush=True)


def profile_steps(path: str) -> None:
    """One profiled full-width step of each slice."""
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.seqblock import make_seq_cp_train_step
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    dev = torch.device("cuda")
    open(path, "w").close()
    shape = (1, 1024, 1024, 3)
    model = amoebanetd(shape, num_classes=1000, num_layers=18, num_filters=416,
                       device=dev, seed=0)
    opt = Optimizer("sgd", lr=1e-3)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16, pallas_conv=True)
    state = TrainState.create(model, opt)
    x = torch.randn(shape, device=dev)
    y = torch.zeros((1,), dtype=torch.long, device=dev)
    _profile(path, "AmoebaNet-D(18,416) 1024^2 bs1 bf16", lambda: step(state, x, y),
             ("halo_conv",))
    del model, state, step, opt
    torch.cuda.empty_cache()
    for name, cfg in SP_PATHS.items():
        model, step, state = sp_parts(dev, cfg["arch"], cfg["image"], cfg["depth"])
        x, y = sp_batch(dev, cfg["image"])
        _profile(path, f"{name} bs1 bf16, one-process 2x2 grid",
                 lambda: step(state, x, y), ("halo_conv",))
        del model, step, state
        torch.cuda.empty_cache()
    seq_step = make_seq_cp_train_step(seq_blocks(SEQ_BLOCKS, dev), None, 1, 1e-3)
    xs, ys = (torch.randn((1, SEQ_T, SEQ_D), device=dev).to(torch.bfloat16)
              for _ in range(2))
    _profile(path, f"SeqBlock(1024,8)x{SEQ_BLOCKS} T {SEQ_T} bs1 bf16",
             lambda: seq_step(xs, ys),
             ("block_flash_fwd", "block_flash_bwd", "block_flash_split"))


def kernel_entry(name, source, replaces, launches, t, library_ms, peak_flops):
    t_bytes = t["bytes"] / HBM_BYTES_PER_S
    t_ops = t["flops"] / peak_flops
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": t["err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": library_ms,
    }


def path_entry(t):
    """One path's per-step sums of a halo-conv kernel, for ``by_path``."""
    b_ms, b_by = bound_of(t["bytes"], t["flops"], PEAK_BF16_FLOPS)
    return {"launches_per_step": t["launches"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"] or None, "bound_ms": b_ms, "bound_by": b_by}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="profile one full-width step of each slice; write the "
                         "tables to PATH")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mpi4dl_tpu_torch.ops import _build

    secs = _build.build_kernels(verbose=True)
    card = card_line()
    print(f"build: {secs:.1f} s on {card}", flush=True)
    check_sass(_build.library_path("halo_conv"))
    check_flash_sass(_build.library_path("block_flash"))
    tot = phase_kernels()
    launches = phase_slice()
    preds = {name: sp_dry_run(cfg["arch"], cfg["image"], cfg["depth"])
             for name, cfg in SP_PATHS.items()}
    for name, seen in preds.items():
        print(f"dry run: {name}: K2 {seen.counts['halo_conv2d_stats']} K1 "
              f"{seen.counts['halo_conv2d']} launches a step", flush=True)
    sp_tot = phase_sp_kernels(preds)
    sp_launches = phase_sp_slice(preds)
    phase_sp_checks()
    k3, k3_bwd = phase_flash_kernels()
    phase_ring()
    k3_launches = phase_seq_slice()
    if args.profile:
        profile_steps(args.profile)
    main_sp = "amoebanet_2048_sp_d2"
    tot["K1"]["launches"] = tot["K2"]["launches"] = 80

    def by_path(key):
        out = {"amoebanet_1024_one_card": path_entry(tot[key])}
        out.update({name: path_entry(sp_tot[name][key]) for name in SP_PATHS})
        return out

    entries = [
        dict(kernel_entry("halo_conv2d", SOURCE, K1_SRC,
                          sp_launches[main_sp]["halo_conv2d"], sp_tot[main_sp]["K1"],
                          sp_tot[main_sp]["K1"]["library_ms"], PEAK_BF16_FLOPS),
             by_path=by_path("K1")),
        dict(kernel_entry("halo_conv2d_stats", SOURCE, K2_SRC,
                          sp_launches[main_sp]["halo_conv2d_stats"], sp_tot[main_sp]["K2"],
                          None, PEAK_BF16_FLOPS),
             by_path=by_path("K2")),
        kernel_entry("block_flash", K3_SOURCE, K3_SRC, k3_launches["block_flash"], k3,
                     k3["library_ms"], PEAK_BF16_FLOPS),
        kernel_entry("block_flash_bwd", K3_SOURCE, K3_BWD_SRC,
                     k3_launches["block_flash_bwd"], k3_bwd, k3_bwd["library_ms"],
                     PEAK_BF16_FLOPS),
    ]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
