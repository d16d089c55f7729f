"""Card-only tests of the PyTorch port: the CUDA kernels against their plain
versions, and a reduced-depth training step through them.  They skip
without a CUDA card.  This file imports no JAX, so it runs on a machine
without it:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import contextlib
import math

import pytest
import torch

from mpi4dl_tpu_torch.ops import halo_conv as hc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(card, dtype, kh=3, kw=3, cin=24, cout=40, h=33, w=50):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((2, h + kh - 1, w + kw - 1, cin), generator=g, device=card)
    wk = torch.randn((kh, kw, cin, cout), generator=g, device=card) * 0.1
    return x.to(dtype), wk.to(dtype)


def _scaled_ulp(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / (2.0 ** -23 * float(ref.abs().max()))


def test_fp32_kernels_within_8_scaled_ulp(card):
    x, wk = _data(card, torch.float32)
    win = (1, 32, 2, 48)
    before = dict(hc.LAUNCHES)
    got = hc.halo_conv2d(x, wk, fuse_relu=True, stat_window=win)
    y1 = hc.halo_conv2d(x, wk)
    torch.cuda.synchronize()
    assert hc.LAUNCHES["halo_conv2d_stats"] == before["halo_conv2d_stats"] + 1
    assert hc.LAUNCHES["halo_conv2d"] == before["halo_conv2d"] + 1
    want = hc.halo_conv2d_plain(x, wk, fuse_relu=True, stat_window=win)
    for g, r in zip(got, want):
        assert _scaled_ulp(g, r) <= 8.0
    assert _scaled_ulp(y1, hc.halo_conv2d_plain(x, wk)) <= 8.0


@pytest.mark.parametrize("kh,kw", [(1, 7), (7, 1)])
def test_bf16_kernels_within_one_ulp_of_the_largest_output(card, kh, kw):
    """Both sides accumulate in fp32 and round once to bf16."""
    x, wk = _data(card, torch.bfloat16, kh, kw, 52, 52, 40, 40)
    y = hc.halo_conv2d(x, wk, fuse_relu=True, stat_window=(0, 40, 0, 40))[0]
    ref = hc.halo_conv2d_plain(x, wk, fuse_relu=True, stat_window=(0, 40, 0, 40))[0]
    assert float((y.float() - ref.float()).abs().max()) <= 2.0 ** -7 * float(ref.float().abs().max())


# bf16 traps of the tensor-core kernel: (kh, kw, cin, cout, n, h, w).
# m = 52 has 104-byte pixel and weight rows (8-byte copies) and a partial
# k16 chunk; 104 and 416 take 16-byte copies; 416 at 32x32 takes the 64x32
# tiles; Cout 300 over Cin 8 is the kernel registry's case (8-byte weight
# copies, a ragged n8 tile); Cin 6 / Cout 10 takes the one-element copies.
BF16_TRAPS = [
    (1, 7, 52, 52, 1, 40, 40),
    (7, 1, 52, 52, 2, 33, 29),
    (1, 7, 104, 104, 1, 32, 32),
    (7, 1, 104, 104, 1, 32, 32),
    (7, 1, 416, 416, 1, 32, 32),
    (1, 7, 416, 416, 1, 32, 32),
    (3, 3, 8, 300, 1, 128, 256),
    (5, 5, 24, 40, 2, 17, 23),
    (3, 3, 6, 10, 1, 9, 7),
]


def _bf16_data(card, kh, kw, cin, cout, n, h, w, shift=0.0, seed=0):
    """bf16 x (standard normal minus ``shift``) and w scaled as the
    layers' init, 1/sqrt(fan in)."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((n, h + kh - 1, w + kw - 1, cin), generator=g, device=card) - shift
    bound = 1.0 / math.sqrt(cin * kh * kw)
    wk = (torch.rand((kh, kw, cin, cout), generator=g, device=card) * 2 - 1) * bound
    return x.to(torch.bfloat16), wk.to(torch.bfloat16)


def _check_bf16(y, ref):
    """Both sides accumulate in fp32 and round once to bf16: one bf16 ULP
    of the largest output."""
    err = float((y.float() - ref.float()).abs().max())
    assert err <= 2.0 ** -7 * float(ref.float().abs().max()), err


def _check_stats(s, ss, s_ref, ss_ref, y_ref, win):
    h0, h1, w0, w1 = win
    yw = y_ref[:, h0:h1, w0:w1, :].float()
    assert float((s - s_ref).abs().max()) <= 2.0 ** -7 * float(yw.abs().sum(dim=(0, 1, 2)).max())
    assert float((ss - ss_ref).abs().max()) <= 2.0 ** -6 * float((yw * yw).sum(dim=(0, 1, 2)).max())


@contextlib.contextmanager
def _nan_empty(monkeypatch):
    """torch.empty / empty_like return NaN-filled tensors inside the block,
    so an output element or scratch row that the kernel does not write
    shows up in the comparison."""
    empty, empty_like = torch.empty, torch.empty_like
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).fill_(math.nan))
        m.setattr(torch, "empty_like", lambda *a, **k: empty_like(*a, **k).fill_(math.nan))
        yield


@pytest.mark.parametrize("kh,kw,cin,cout,n,h,w", BF16_TRAPS)
def test_bf16_kernels_at_trap_shapes(card, monkeypatch, kh, kw, cin, cout, n, h, w):
    """K2 with a margin-excluding window and K1, against the plain version;
    x shifted by -1 so that ReLU zeroes most of it."""
    x, wk = _bf16_data(card, kh, kw, cin, cout, n, h, w, shift=1.0)
    win = (1, h - 1, 2, w - 2)
    with _nan_empty(monkeypatch):
        y, s, ss = hc.halo_conv2d(x, wk, fuse_relu=True, stat_window=win)
        y1 = hc.halo_conv2d(x, wk)
    yr, sr, ssr = hc.halo_conv2d_plain(x, wk, fuse_relu=True, stat_window=win)
    assert y.dtype == torch.bfloat16 and y.shape == yr.shape == (n, h, w, cout)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all()
                and torch.isfinite(ss).all())
    _check_bf16(y, yr)
    _check_stats(s, ss, sr, ssr, yr, win)
    _check_bf16(y1, hc.halo_conv2d_plain(x, wk))


@pytest.mark.parametrize("kh,kw,cin,cout,n,h,w", [BF16_TRAPS[1], BF16_TRAPS[6]])
def test_bf16_in_fp32_out(card, kh, kw, cin, cout, n, h, w):
    """bf16 products are exact in fp32, so an fp32 output differs from the
    plain version's only by summation order: within 2^-10 of the sum of
    the terms' magnitudes."""
    x, wk = _bf16_data(card, kh, kw, cin, cout, n, h, w)
    y = hc.halo_conv2d(x, wk, out_dtype=torch.float32, fuse_relu=True)
    ref = hc.halo_conv2d_plain(x, wk, out_dtype=torch.float32, fuse_relu=True)
    mag = hc.halo_conv2d_plain(torch.relu(x).abs(), wk.abs(), out_dtype=torch.float32)
    assert y.dtype == torch.float32
    assert bool(((y - ref).abs() <= 2.0 ** -10 * mag + 1e-30).all())


@pytest.mark.parametrize("kh,kw,cin,cout,n,h,w", [
    BF16_TRAPS[0], BF16_TRAPS[4], BF16_TRAPS[6],
    (1, 7, 104, 104, 1, 127, 135),  # the 128x128 tiles
    (1, 7, 416, 416, 1, 16, 17),    # a grid smaller than one wave
])
def test_bf16_kernels_are_deterministic(card, kh, kw, cin, cout, n, h, w):
    """No float atomics: two launches give bitwise-equal y, sum and
    sumsq."""
    x, wk = _bf16_data(card, kh, kw, cin, cout, n, h, w, seed=1)
    win = (1, h - 1, 2, w - 2)
    a = hc.halo_conv2d(x, wk, fuse_relu=True, stat_window=win)
    b = hc.halo_conv2d(x, wk, fuse_relu=True, stat_window=win)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("kh,kw,cin,cout,n,h,w", [
    (3, 3, 16, 16, 1, 131, 129),   # 16,899 pixels: 133 tiles of 128
    (1, 7, 104, 104, 1, 127, 135), # 17,145 pixels, the 128x128 tiles
    (1, 7, 104, 104, 3, 23, 19),   # 1,311 pixels: 21 tiles of 64
    (7, 1, 416, 416, 1, 31, 33),   # 1,023 pixels, the 64x32 tiles
    (1, 7, 416, 416, 1, 16, 17),   # 272 pixels, less than a wave
])
def test_stats_scratch_follows_the_launch_tile(card, monkeypatch, kh, kw, cin, cout, n, h, w):
    """N·H·W is a multiple of no tile, and the scratch starts as NaN: the
    statistics are right only if the wrapper sizes the scratch by this
    launch's own pixel tile (too many rows sum NaN; the library refuses a
    launch given another row count)."""
    x, wk = _bf16_data(card, kh, kw, cin, cout, n, h, w, seed=2)
    pixels = n * h * w
    assert pixels % 64 != 0
    assert hc.stat_rows(x, wk) in (-(-pixels // 64), -(-pixels // 128))
    win = (0, h, 0, w)
    with _nan_empty(monkeypatch):
        y, s, ss = hc.halo_conv2d(x, wk, fuse_relu=True, stat_window=win)
    yr, sr, ssr = hc.halo_conv2d_plain(x, wk, fuse_relu=True, stat_window=win)
    _check_bf16(y, yr)
    _check_stats(s, ss, sr, ssr, yr, win)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_scratch_of_another_size_is_refused(card, dtype):
    """The library checks the scratch's row count against its own plan for
    the launch: one row fewer or more is cudaErrorInvalidValue, and nothing
    runs."""
    x, wk = _bf16_data(card, 1, 7, 104, 104, 3, 23, 19)
    x, wk = x.to(dtype), wk.to(dtype)
    rows = hc.stat_rows(x, wk)
    lib = hc._library()
    y = torch.zeros((3, 23, 19, 104), dtype=dtype, device=card)
    for bad in (rows - 1, rows + 1):
        part = torch.zeros((2, bad, 104), dtype=torch.float32, device=card)
        err = lib.halo_conv2d_launch(
            x.data_ptr(), wk.data_ptr(), y.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), 3, 23, 25, 104, 1, 7, 104,
            int(dtype == torch.bfloat16), int(dtype == torch.bfloat16), 1,
            0, 23, 0, 19, bad, hc._sms(card), torch.cuda.current_stream().cuda_stream)
        assert lib.halo_conv2d_error_string(err).decode() == "invalid argument"
    torch.cuda.synchronize()
    assert not bool(y.any())


def test_autograd_through_the_kernels(card):
    """The fused op's backward on the card (K1 as dx) against the same
    backward run on the CPU with the plain versions."""
    x, wk = _data(card, torch.float32, 1, 7, 16, 16, 12, 12)
    win = (0, 12, 0, 12)
    grads = []
    for dev in (card, torch.device("cpu")):
        xx = x.detach().to(dev).requires_grad_()
        ww = wk.detach().to(dev).requires_grad_()
        y, s, ss = hc.fused_relu_conv_bn_t(xx, ww, win)
        ((y * 0.3).sum() + (s * 0.7).sum() + (ss * 0.11).sum()).backward()
        grads.append((xx.grad.cpu(), ww.grad.cpu()))
    (gx, gw), (rx, rw) = grads
    torch.testing.assert_close(gx, rx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gw, rw, rtol=1e-4, atol=1e-4)


def test_reduced_depth_step_launches_the_kernels(card):
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    model = amoebanetd((1, 128, 128, 3), num_classes=10, num_layers=3,
                       num_filters=64, device=card)
    opt = Optimizer("sgd", lr=0.01)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16, pallas_conv=True)
    hc.reset_launch_counts()
    _, m = step(TrainState.create(model, opt), torch.randn((1, 128, 128, 3), device=card),
                torch.zeros((1,), dtype=torch.long, device=card))
    assert math.isfinite(float(m["loss"]))
    assert hc.LAUNCHES["halo_conv2d_stats"] == hc.LAUNCHES["halo_conv2d"] == 20


# A fault of the single-device path: the AmoebaNet gradient on the card.


def _pool_grads(dev, pool_fn, x, ct):
    xx = x.detach().clone().to(dev).requires_grad_()
    y = pool_fn(xx)
    (y * ct.to(dev)).sum().backward()
    return y.detach().cpu(), xx.grad.cpu()


@pytest.mark.parametrize("stride", [1, 2])
def test_library_avg_pool_backward_on_card(card, stride):
    """``F.avg_pool2d`` over the layers' channels-last view (NHWC permuted
    to NCHW), 3x3 padded windows, ``count_include_pad=False``: its forward
    on the card agrees with the CPU; this records how far its backward
    is from the CPU's (the reason ``layers.Pool2d`` sums its windows)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 32, 32, 8), generator=g)
    ct = torch.randn((1, 32 // stride, 32 // stride, 8), generator=g)

    def pool(t):
        return F.avg_pool2d(t.permute(0, 3, 1, 2), 3, stride, 1,
                            count_include_pad=False).permute(0, 2, 3, 1)

    (y, gx), (ry, rgx) = (_pool_grads(d, pool, x, ct) for d in (card, "cpu"))
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-6)
    print(f"F.avg_pool2d stride {stride} backward, card vs CPU: max|Δ| "
          f"{float((gx - rgx).abs().max()):.3g} of max|ref| {float(rgx.abs().max()):.3g}")


@pytest.mark.parametrize("op,stride", [("avg", 1), ("avg", 2), ("max", 1), ("max", 2)])
def test_pool_backward_on_card_matches_cpu(card, op, stride):
    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
    from mpi4dl_tpu_torch.layers import Pool2d

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 32, 32, 8), generator=g)
    ct = torch.randn((2, 32 // stride, 32 // stride, 8), generator=g)
    pool = Pool2d(op, 3, stride, 1, count_include_pad=False)
    (y, gx), (ry, rgx) = (_pool_grads(d, lambda t: pool(t, ApplyCtx(train=True)), x, ct)
                          for d in (card, "cpu"))
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx, rgx, rtol=1e-5, atol=1e-6)


def test_amoebanet_gradient_on_card_matches_cpu(card):
    """The single-device AmoebaNet-D gradient on the card, with and
    without the fused kernels, within 1e-4 (norm-relative, fp32) of the
    CPU's: the check that caught the library average pool's backward."""
    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.train import cross_entropy

    shape = (1, 128, 128, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([3])

    def grads(dev, knob):
        model = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=32,
                           device=dev, seed=0)
        if dev != "cpu":
            model.load_state_dict(ref_model.state_dict())
        ctx = ApplyCtx(train=True, spatial=SpatialCtx(use_pallas_conv=True) if knob else None)
        loss = cross_entropy(model(x.to(dev), ctx), y.to(dev))
        return [t.cpu() for t in torch.autograd.grad(loss, list(model.parameters()))], model

    ref, ref_model = grads("cpu", False)
    norm = sum(float((t.double() ** 2).sum()) for t in ref) ** 0.5
    for knob in (False, True):
        got, _ = grads(card, knob)
        diff = sum(float(((a - b).double() ** 2).sum()) for a, b in zip(got, ref)) ** 0.5
        assert diff <= 1e-4 * norm, (knob, diff / norm)


# The spatial-parallel slice: K1/K2 on tiles that carry their halo margins.


@pytest.mark.parametrize("kh,kw,margin", [(1, 7, 3), (7, 1, 3), (3, 3, 2), (5, 5, 2)])
def test_k2_excludes_the_margin_of_a_2x2_tile_batch(card, kh, kw, margin):
    """K2 on four tiles (the one-process 2x2 grid folds them into the
    batch) that still carry a margin of 2 or 3 pixels after the conv: the
    statistics window leaves it out, as D2's premargin runs ask."""
    n, h, w = 4, 40 + 2 * margin, 36 + 2 * margin
    x, wk = _bf16_data(card, kh, kw, 104, 104, n, h, w, seed=3)
    win = (margin, h - margin, margin, w - margin)
    y, s, ss = hc.halo_conv2d(x, wk, fuse_relu=True, stat_window=win)
    yr, sr, ssr = hc.halo_conv2d_plain(x, wk, fuse_relu=True, stat_window=win)
    _check_bf16(y, yr)
    _check_stats(s, ss, sr, ssr, yr, win)
    full = hc.halo_conv2d_plain(x, wk, fuse_relu=True, stat_window=(0, h, 0, w))
    assert float((full[1] - sr).abs().max()) > 0  # the margin was left out


@pytest.mark.parametrize("cin", [3, 16, 32, 64])
def test_k1_forward_at_resnet_widths(card, cin):
    """K1's forward at ResNet's stage-1 widths on a tile batch with its
    D2 margin: Cin 3 takes one-element copies, 16-64 the 16-byte ones."""
    x, wk = _bf16_data(card, 3, 3, cin, 16, 4, 66, 70, seed=cin)
    y = hc.halo_conv2d(x, wk)
    _check_bf16(y, hc.halo_conv2d_plain(x, wk))
    assert torch.equal(y, hc.halo_conv2d(x, wk))


@pytest.mark.parametrize("arch,image,depth", [("amoebanet", 256, 3), ("resnet", 128, 11)])
def test_sp_step_launches_what_the_dispatch_predicts(card, arch, image, depth):
    """A reduced-depth SP D2 step on the one-process 2x2 grid launches
    exactly the K1/K2 calls of its dry run on the meta device."""
    import warnings

    from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for
    from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

    def parts(dev):
        shape = (1, image, image, 3)
        model = (amoebanetd(shape, num_classes=10, num_layers=depth, num_filters=64,
                            device=dev) if arch == "amoebanet"
                 else get_resnet_v2(shape, depth, 10, device=dev))
        opt = Optimizer("sgd", lr=0.01)
        sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=True,
                             use_pallas_conv=True)
        return (make_spatial_train_step(model, opt, sp, compute_dtype=torch.bfloat16),
                TrainState.create(model, opt))

    warnings.simplefilter("ignore")
    meta = torch.device("meta")
    step, state = parts(meta)
    with hc.count_dispatches() as seen:
        step(state, torch.zeros((1, image, image, 3), device=meta),
             torch.zeros((1,), dtype=torch.long, device=meta))
    step, state = parts(card)
    hc.reset_launch_counts()
    _, m = step(state, torch.randn((1, image, image, 3), device=card),
                torch.zeros((1,), dtype=torch.long, device=card))
    assert math.isfinite(float(m["loss"]))
    assert dict(hc.LAUNCHES) == seen.counts
    assert seen.counts["halo_conv2d"] > 0


# ---------------------------------------------------------------------------
# K3, the block-flash attention kernel.
# ---------------------------------------------------------------------------


def _flash_check(got, ref, bound=1e-5):
    """m on its unmasked rows and o_hat / l within bound·max(1, max|ref|);
    l within rtol bound; masked rows exactly (0, NEG_INF, 0)."""
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    (o, m, l), (ro, rm, rl) = got, ref
    live = rm > fa.NEG_INF * 0.5
    assert torch.equal(live, m > fa.NEG_INF * 0.5)
    assert torch.all(m[~live] == fa.NEG_INF) and torch.all(l[~live] == 0)
    assert torch.all(o[~live] == 0)
    if live.any():
        dm = float((m[live] - rm[live]).abs().max())
        assert dm <= bound * max(1.0, float(rm[live].abs().max())), dm
        assert float(((l - rl).abs() / rl.clamp_min(1e-30))[live].max()) <= bound
    on, ron = o / l.clamp_min(1e-30)[..., None], ro / rl.clamp_min(1e-30)[..., None]
    assert float((on - ron).abs().max()) <= bound * max(1.0, float(ron.abs().max()))


@pytest.mark.parametrize("kv_dtype,causal,q_off,k_off", [
    (torch.float32, False, 0, 0),
    (torch.bfloat16, True, 130, 40),     # a ring hop: partly masked rows
    (torch.float32, True, 0, 500),       # every row masked
])
def test_block_flash_kernel_matches_plain(card, kv_dtype, causal, q_off, k_off):
    """Tail shape: Tq, Tk off the 64-row tiles and D = 40."""
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((3, 77, 40), generator=g, device=card)
    k, v = (torch.randn((3, 201, 40), generator=g, device=card).to(kv_dtype)
            for _ in range(2))
    args = (q_off, k_off, causal, 40 ** -0.5)
    before = fa.LAUNCHES["block_flash"]
    got = fa.block_flash(q, k, v, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["block_flash"] == before + 1
    _flash_check(got, fa.block_flash_plain(q, k, v, *args))


def test_block_flash_refuses_wide_heads(card):
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    q = torch.zeros((1, 8, 136), device=card)
    with pytest.raises(ValueError, match="D <= 128"):
        fa.block_flash(q, q, q)


def test_block_flash_autograd_on_card_matches_cpu(card):
    """flash_attention_local's gradients on the card (K3 forward) against
    the same backward on the CPU (plain forward)."""
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(1)
    qkv = [torch.randn((1, 300, 2, 64), generator=g) for _ in range(3)]
    grads = []
    bwd_before = fa.LAUNCHES["block_flash_bwd"]
    for dev in (card, torch.device("cpu")):
        ts = [x.to(dev).requires_grad_() for x in qkv]
        out = fa.flash_attention_local(*ts, causal=True)
        (out * out).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert fa.LAUNCHES["block_flash_bwd"] == bwd_before  # fp32: PyTorch ops


# bf16 q, k, v: the tensor-core forward and the backward kernel at their
# traps, (Tq, Tk, D, causal, q_off, k_off): tails of both tiles at D 40
# (80-byte rows: 16-byte copies), D 100 (200-byte rows: 8-byte copies), D 33
# (one-element copies), a ring hop with partly masked rows, the diagonal of
# a hop at full width, and a block wholly in the future.
BF16_FLASH_TRAPS = [
    (77, 201, 40, True, 0, 0),
    (77, 201, 100, False, 0, 0),
    (77, 201, 33, True, 20, 0),
    (77, 201, 40, True, 130, 40),
    (128, 128, 128, True, 128, 128),
    (77, 201, 40, True, 0, 500),
]


def _bwd_check(got, want, rtol=1e-4, atol=1e-5):
    """rtol, atol scaled by max|ref| (the JAX gradient test's tolerance); a
    zero reference exactly."""
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        big = float(w.abs().max())
        if big == 0.0:
            assert bool((g == 0).all())
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol * big)


@pytest.mark.parametrize("t_q,t_k,d,causal,q_off,k_off", BF16_FLASH_TRAPS)
def test_bf16_block_flash_forward_and_backward_kernels(card, t_q, t_k, d, causal,
                                                       q_off, k_off):
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=card).manual_seed(2)
    q = torch.randn((3, t_q, d), generator=g, device=card).to(torch.bfloat16)
    k, v = (torch.randn((3, t_k, d), generator=g, device=card).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((3, t_q, d), generator=g, device=card)
    dl = torch.randn((3, t_q), generator=g, device=card)
    args = (q_off, k_off, causal, d ** -0.5)
    before = dict(fa.LAUNCHES)
    got = fa.block_flash(q, k, v, *args)
    again = fa.block_flash(q, k, v, *args)
    grads = fa.block_flash_bwd(q, k, v, got[1], do, dl, *args)
    grads2 = fa.block_flash_bwd(q, k, v, got[1], do, dl, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["block_flash"] == before["block_flash"] + 2
    assert fa.LAUNCHES["block_flash_bwd"] == before["block_flash_bwd"] + 2
    _flash_check(got, fa.block_flash_plain(q, k, v, *args))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    _bwd_check(grads, fa.block_flash_bwd_plain(q, k, v, got[1], do, dl, *args))


def test_block_flash_bwd_kernel_takes_bf16_only(card):
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    q = torch.zeros((1, 8, 16), device=card)
    with pytest.raises(TypeError, match="bf16 q, k and v"):
        fa.block_flash_bwd(q, q, q, q[..., 0], q, q[..., 0])


def test_bf16_flash_attention_local_autograd_matches_cpu(card):
    """bf16 q, k, v: the card's kernels (forward and backward) against the
    plain versions on the CPU, through flash_attention_local.  Both sides
    round the output and each gradient to bf16 once after fp32 work that
    differs in order, so values may differ by one bf16 ULP of the largest
    at each of those two roundings: |Δ| ≤ 2^-6·max|ref|."""
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(3)
    qkv = [torch.randn((1, 300, 2, 64), generator=g).to(torch.bfloat16) for _ in range(3)]
    grads = []
    before = fa.LAUNCHES["block_flash_bwd"]
    for dev in (card, torch.device("cpu")):
        ts = [x.to(dev).requires_grad_() for x in qkv]
        out = fa.flash_attention_local(*ts, causal=True)
        (out.float() ** 2).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    assert fa.LAUNCHES["block_flash_bwd"] == before + 1
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -6 * float(want.float().abs().max()), err


def test_seqblock_step_launches_k3_once_per_block(card):
    from mpi4dl_tpu_torch.models.seqblock import SeqBlock, make_seq_cp_train_step
    from mpi4dl_tpu_torch.ops import flash_attention as fa

    blocks = torch.nn.ModuleList(SeqBlock(128, 2, device=card, seed=i) for i in range(3))
    step = make_seq_cp_train_step(blocks, None, 1, 1e-3)
    x = torch.randn((1, 512, 128), device=card).to(torch.bfloat16)
    y = torch.randn((1, 512, 128), device=card).to(torch.bfloat16)
    fa.reset_launch_counts()
    loss = float(step(x, y))
    assert math.isfinite(loss)
    assert fa.LAUNCHES["block_flash"] == 3
    assert fa.LAUNCHES["block_flash_bwd"] == 3
