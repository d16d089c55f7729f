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
from mpi4dl_tpu_torch.utils.devcheck import norm_rel

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


@pytest.mark.parametrize("version", [1, 2])
def test_resnet_gradient_on_card_matches_cpu(card, version):
    """ResNet v1 (depth 8) and v2 (depth 11) on the card, with and without
    the fused kernels, within 1e-4 (norm-relative, fp32) of the CPU's:
    strided convs whose dx is the library's, projection shortcuts, biased
    convs and GlobalAvgPool."""
    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
    from mpi4dl_tpu_torch.models import get_resnet_v1, get_resnet_v2
    from mpi4dl_tpu_torch.train import cross_entropy

    shape = (2, 64, 64, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([3, 7])
    build = get_resnet_v1 if version == 1 else get_resnet_v2
    depth = 8 if version == 1 else 11
    ref_model = build(shape, depth, 10, device="cpu", seed=0)

    def grads(dev, knob):
        model = build(shape, depth, 10, device=dev, seed=0)
        model.load_state_dict(ref_model.state_dict())
        ctx = ApplyCtx(train=True, spatial=SpatialCtx(use_pallas_conv=True) if knob else None)
        loss = cross_entropy(model(x.to(dev), ctx), y.to(dev))
        return torch.autograd.grad(loss, list(model.parameters()))

    ref = grads("cpu", False)
    for knob in (False, True):
        assert norm_rel(grads(card, knob), ref) <= 1e-4, knob


@pytest.mark.parametrize("d2,local_dp,batch", [(False, None, 2), (False, None, 4),
                                                (True, None, 4), (True, 2, 4), (True, 4, 4)])
def test_sp_step_on_card_matches_cpu(card, d2, local_dp, batch):
    """The reduced-depth SP D1 and D2 steps on the one-process grid (and D2
    with the ``batch_split`` junction at degrees 2 and 4).  In float64 with
    the kernels off, the whole step on the card (halo exchanges, tile
    scatter and gather, the junction and their adjoints) against the CPU's:
    loss within rtol 1e-10, gradient within 1e-8 (norm-relative).  In fp32
    with the kernels on (batch 4): the loss within rtol 1e-5, and every
    layer call and K2 window of the step, replayed on its recorded input
    on the card and on the CPU, within 1e-4 (norm-relative) in its output
    and its VJP.  The fp32 whole step's gradient is not held to 1e-4:
    AmoebaNet's ReLU → BatchNorm → max-pool chains route it by ties that
    fp32 rounding flips (a 1e-6 perturbation of the input moves it by ~1%
    on the CPU alone; chip_smoke.py prints both)."""
    import warnings

    from mpi4dl_tpu_torch.utils.devcheck import replay_units, sp_step_run

    warnings.simplefilter("ignore")  # the pad-once pool notice
    f64 = torch.float64
    loss, ref, model = sp_step_run("cpu", None, d2, local_dp, dtype=f64, batch=batch)
    loss_d, got, _ = sp_step_run(card, model.state_dict(), d2, local_dp, dtype=f64,
                                 batch=batch)
    assert abs(loss_d - loss) <= 1e-10 * abs(loss)
    assert norm_rel(got, ref) <= 1e-8
    if batch != 4:
        return
    loss, _, model = sp_step_run("cpu", None, d2, local_dp)
    loss_d, _, _ = sp_step_run(card, model.state_dict(), d2, local_dp)
    assert abs(loss_d - loss) <= 1e-5 * abs(loss)
    units, err_y, err_g = replay_units(
        model, lambda: sp_step_run("cpu", None, d2, local_dp, model=model), card)
    assert units > 0 and err_y <= 1e-4 and err_g <= 1e-4, (units, err_y, err_g)


def test_pipeline_step_on_card_matches_cpu(card):
    """GPipe and 1F1B on the one-process stage chain, kernels on, fp32,
    AmoebaNet-D(3, 32) 128² bs4 in 4 micro-batches over 4 stages: each
    schedule's launches equal the dry run's, its loss is within rtol 1e-5
    of the CPU's, and 1F1B's parameters after the step are within
    tests/test_1f1b.py's TOL (rtol 2e-3 / atol 5e-5) of GPipe's."""
    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.partition import StagePartition
    from mpi4dl_tpu_torch.parallel.pipeline import (
        init_pipeline_state, make_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.train import Optimizer

    shape = (4, 128, 128, 3)
    g = torch.Generator().manual_seed(3)
    x, y = torch.randn(shape, generator=g), torch.tensor([0, 3, 5, 8])
    init = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=32,
                      device="cpu").state_dict()

    def run(dev, schedule):
        model = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=32, device=dev)
        if dev != "meta":
            model.load_state_dict(init)
        part = StagePartition.build(model, 4, (1, *shape[1:]))
        opt = Optimizer("sgd", lr=0.01)
        step = make_pipeline_train_step(part, opt, StageChain(4), 4, schedule=schedule,
                                        remat=False, pallas_conv=True)
        _, m = step(init_pipeline_state(part, opt, StageChain(4)), x.to(dev), y.to(dev))
        return m["loss"], model

    params = {}
    for schedule in ("gpipe", "1f1b"):
        with hc.count_dispatches() as seen:
            run("meta", schedule)
        hc.reset_launch_counts()
        loss, model = run(card, schedule)
        assert dict(hc.LAUNCHES) == seen.counts and seen.counts["halo_conv2d"] > 0
        ref, _ = run("cpu", schedule)
        assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref)), schedule
        params[schedule] = [p.detach().cpu() for p in model.parameters()]
    for a, b in zip(params["gpipe"], params["1f1b"]):
        torch.testing.assert_close(b, a, rtol=2e-3, atol=5e-5)


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


# GEMS, SP x PP and SP + GEMS, and the striped ResNet branch (C3).

ENGINE_CASES = [("gems", dict(split=s, parts=2, schedule=sch), 1)
                for s in (4, 3) for sch in ("gpipe", "1f1b")] + [
    (e, dict(parts=p, schedule=sch), 2)
    for e, p in (("sp_pp", 2), ("sp_gems", 1)) for sch in ("gpipe", "1f1b")]


@pytest.mark.parametrize("engine,extra,micro", ENGINE_CASES)
def test_engine_on_card_matches_the_single_card_step(card, engine, extra, micro):
    """ResNet-11 v2 32², fp32, kernels on, two steps on the card against the
    single-card step accumulated over the same micro-batches: losses rtol
    1e-4, parameters rtol 2e-3 / atol 1e-5 (the JAX GEMS / SP tests')."""
    from mpi4dl_tpu_torch.utils.devcheck import engine_run

    losses, got = engine_run(card, engine, micro=micro, pallas=True, **extra)
    want_losses, want = engine_run(card, "single", micro=micro, pallas=True)
    for a, b in zip(losses, want_losses):
        assert abs(a - b) <= 1e-4 * abs(b), (losses, want_losses)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("engine,extra,micro", ENGINE_CASES[::2])
def test_engine_in_float64_on_card_matches_the_single_card_step(card, engine, extra, micro):
    """AmoebaNet-D(3, 32) 128², float64, kernels off (no max-pool tie
    flips): losses rtol 1e-10, the updates within 1e-8 (norm-relative)."""
    from mpi4dl_tpu_torch.utils.devcheck import engine_run

    kw = dict(arch="amoebanet", image=128, spatial_until=5, dtype=torch.float64)
    init = engine_run("cpu", "single", steps=0, **kw)[1]
    losses, got = engine_run(card, engine, micro=micro, **extra, **kw)
    want_losses, want = engine_run(card, "single", micro=micro, **kw)
    for a, b in zip(losses, want_losses):
        assert abs(a - b) <= 1e-10 * abs(b), (losses, want_losses)
    keys = [k for k in init if init[k].is_floating_point()]
    assert norm_rel([got[k] - init[k] for k in keys],
                    [want[k] - init[k] for k in keys]) <= 1e-8


def test_gems_and_sp_pipeline_launch_what_the_dispatch_predicts(card):
    """AmoebaNet-D(3, 64) 256², bf16, kernels on: the GEMS chain (4 stages,
    both schedules) and the SP x PP grid (2x2, D2, 2 stages) launch exactly
    the K1/K2 calls of their dry runs."""
    import warnings

    from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for
    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.gems import make_gems_train_step
    from mpi4dl_tpu_torch.parallel.partition import StagePartition
    from mpi4dl_tpu_torch.parallel.pipeline import init_pipeline_state
    from mpi4dl_tpu_torch.parallel.sp_pipeline import (
        SPPipeline, init_sp_pipeline_state, make_sp_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import Optimizer

    shape = (4, 256, 256, 3)

    def parts(dev, which):
        model = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=64, device=dev)
        opt = Optimizer("sgd", lr=0.01)
        if which == "sp_pp":
            model.spatial_until = 5
            sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=True,
                                 use_pallas_conv=True)
            spp = SPPipeline.build(model, 2, sp, 2, junction="gather")
            return (make_sp_pipeline_train_step(spp, opt, StageChain(2), 2,
                                                compute_dtype=torch.bfloat16),
                    init_sp_pipeline_state(spp, opt, StageChain(2)))
        part = StagePartition.build(model, 4, (1, *shape[1:]))
        return (make_gems_train_step(part, opt, StageChain(4), 2, schedule=which,
                                     compute_dtype=torch.bfloat16, pallas_conv=True),
                init_pipeline_state(part, opt, StageChain(4)))

    warnings.simplefilter("ignore")
    meta = torch.device("meta")
    for which in ("gpipe", "1f1b", "sp_pp"):
        step, state = parts(meta, which)
        with hc.count_dispatches() as seen:
            step(state, torch.zeros(shape, device=meta),
                 torch.zeros((4,), dtype=torch.long, device=meta))
        step, state = parts(card, which)
        hc.reset_launch_counts()
        _, m = step(state, torch.randn(shape, device=card),
                    torch.arange(4, device=card))
        assert math.isfinite(float(m["loss"]))
        assert dict(hc.LAUNCHES) == seen.counts and seen.counts["halo_conv2d"] > 0, which


@pytest.mark.parametrize("exact", ["0", "1"])
def test_striped_resnet_branch_on_card_matches_cpu(card, monkeypatch, exact):
    """C3: the striped v2 branch (gates lowered) on the card against the
    CPU: loss rtol 1e-5, gradients and running statistics within 1e-4
    (norm-relative)."""
    from mpi4dl_tpu_torch.utils.devcheck import hstripe_gates, hstripe_run

    monkeypatch.setenv("MPI4DL_HSTRIPE_EXACT", exact)
    with hstripe_gates():
        loss, grads, stats, model = hstripe_run("cpu")
        loss_d, grads_d, stats_d, _ = hstripe_run(card, model.state_dict())
    assert abs(loss_d - loss) <= 1e-5 * abs(loss)
    assert norm_rel(grads_d, grads) <= 1e-4 and norm_rel(stats_d, stats) <= 1e-4


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


# ---------------------------------------------------------------------------
# Multi-level SP and the memory levers: the card against the CPU.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,method,counts", [
    ("sp", "square", [4, 2]), ("sp", "vertical", [2, 1]), ("sp_pp", "square", [4, 2]),
])
def test_multilevel_engines_on_card_match_cpu(card, engine, method, counts):
    """Multi-level SP and SP x PP, AmoebaNet-D(3, 32) 128² in float64 with
    the kernels off, two steps: losses rtol 1e-10, updates within 1e-8."""
    from mpi4dl_tpu_torch.utils.devcheck import engine_run

    kw = dict(arch="amoebanet", dtype=torch.float64, image=128,
              levels=(method, counts, [3, 6]), micro=2 if engine == "sp_pp" else 4)
    if engine == "sp_pp":
        kw["parts"] = 2
    init = engine_run("cpu", "single", steps=0, arch="amoebanet", dtype=torch.float64,
                      image=128)[1]
    losses, got = engine_run(card, engine, **kw)
    want_losses, want = engine_run("cpu", engine, **kw)
    keys = [k for k in init if init[k].is_floating_point()]
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses)) <= 1e-10
    assert norm_rel([got[k] - init[k] for k in keys],
                    [want[k] - init[k] for k in keys]) <= 1e-8


def test_multilevel_step_launches_what_the_dispatch_predicts(card):
    """The multi-level step's K1/K2 launches equal its dry run's, and no
    degenerate level launches a kernel."""
    from mpi4dl_tpu_torch.layer_ctx import spatial_levels_for
    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

    for counts in ([4, 2], [4, 1]):
        calls = {}
        for dev in ("meta", card):
            model = amoebanetd((1, 256, 256, 3), num_classes=10, num_layers=3,
                               num_filters=32, device=dev)
            ctxs = spatial_levels_for("square", counts, tiles=TileGrid(2, 2),
                                      d2_mode=True, use_pallas_conv=True)
            opt = Optimizer("sgd", lr=1e-3)
            step = make_spatial_train_step(model, opt, ctxs[0], compute_dtype=torch.bfloat16,
                                           levels=[(3, ctxs[0]), (6, ctxs[1])])
            x = torch.zeros((1, 256, 256, 3), device=dev)
            y = torch.zeros((1,), dtype=torch.long, device=dev)
            if dev == "meta":
                with hc.count_dispatches() as seen:
                    step(TrainState.create(model, opt), x, y)
                calls[dev] = seen.counts
            else:
                before = dict(hc.LAUNCHES)
                step(TrainState.create(model, opt), torch.randn_like(x), y)
                torch.cuda.synchronize()
                calls[dev] = {k: hc.LAUNCHES[k] - before[k] for k in before}
        assert calls["meta"] == calls[card] and calls[card]["halo_conv2d"] > 0, calls


@pytest.mark.parametrize("h,w,kh,kw,s,pad", [
    (64, 64, 3, 3, 2, ((1, 1), (1, 1))), (64, 64, 1, 1, 2, ((0, 0), (0, 0))),
    (63, 61, 3, 3, 2, ((1, 2), (0, 1))),
])
def test_conv_phase_on_card_matches_cpu(card, h, w, kh, kw, s, pad):
    """The phase-decomposed strided conv: value and VJPs on the card within
    1e-5 (norm-relative, fp32, TF32 off) of the CPU's."""
    from mpi4dl_tpu_torch.ops.conv_phase import conv2d_strided_t

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, h, w, 16), generator=g)
    wk = torch.randn((kh, kw, 16, 24), generator=g) / (kh * kw)
    ct = None
    outs = []
    for dev in ("cpu", card):
        xt = x.to(dev).requires_grad_(True)
        wt = wk.to(dev).requires_grad_(True)
        y = conv2d_strided_t(xt, wt, (s, s), pad)
        ct = torch.randn(y.shape, generator=g) if ct is None else ct
        outs.append([y] + list(torch.autograd.grad(y, (xt, wt), ct.to(dev))))
    for a, b in zip(*outs):
        assert norm_rel([b.detach().cpu()], [a.detach()]) <= 1e-5


def test_hstripe_conv2d_on_card_matches_cpu(card, monkeypatch):
    """``hstripe_conv2d`` striped (budget lowered): value and VJPs on the
    card within 1e-5 of the CPU's."""
    from mpi4dl_tpu_torch.ops import hstripe_conv

    monkeypatch.setattr(hstripe_conv, "_PATCH_BUDGET", 20000)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 61, 40, 8), generator=g)
    wk = torch.randn((3, 3, 8, 12), generator=g) / 9
    ct = None
    outs = []
    for dev in ("cpu", card):
        xt = x.to(dev).requires_grad_(True)
        wt = wk.to(dev).requires_grad_(True)
        y = hstripe_conv.hstripe_conv2d(xt, wt, (1, 1), (1, 1))
        ct = torch.randn(y.shape, generator=g) if ct is None else ct
        outs.append([y] + list(torch.autograd.grad(y, (xt, wt), ct.to(dev))))
    for a, b in zip(*outs):
        assert norm_rel([b.detach().cpu()], [a.detach()]) <= 1e-5


# ---------------------------------------------------------------------------
# Data and checkpoints on the card.
# ---------------------------------------------------------------------------

_RUNNER = ["--image-size", "32", "--num-layers", "1", "--batch-size", "2",
           "--steps-per-epoch", "2"]


def test_runner_checkpoint_round_trip_on_card(card, tmp_path):
    """The lp runner on the card: a run stopped after one epoch resumes at
    step 2 with its saved state bitwise, and trains on like an
    uninterrupted run (losses rtol 1e-5: the card's library convolutions
    need not be bitwise repeatable)."""
    from mpi4dl_tpu_torch.benchmarks.common import run
    from mpi4dl_tpu_torch.checkpoint import load_arrays, state_leaves

    a = _RUNNER + ["--checkpoint-dir", str(tmp_path / "a")]
    run("lp", "resnet", a)
    restored = []

    def on_restore(state, mgr):
        saved, _ = load_arrays(mgr.last_restore.path)
        for i, leaf in enumerate(state_leaves(state)):
            got = leaf.full()
            assert got.device.type == "cpu" and torch.equal(got, saved[f"leaf_{i}"]), i
        restored.append(len(saved))

    resumed = run("lp", "resnet", a + ["--num-epochs", "2"], on_restore=on_restore)
    whole = run("lp", "resnet", _RUNNER + ["--num-epochs", "2", "--checkpoint-dir",
                                           str(tmp_path / "b")])
    assert restored and resumed["start_step"] == 2 and resumed["final_step"] == 4
    for x, y in zip(resumed["losses"], whole["losses"][2:]):
        assert math.isclose(x, y, rel_tol=1e-5)
    got, _ = load_arrays(str(tmp_path / "a" / "ckpt_4"))
    want, _ = load_arrays(str(tmp_path / "b" / "ckpt_4"))
    for k in got:
        assert torch.allclose(got[k].double(), want[k].double(), rtol=1e-5, atol=1e-6), k


def test_jax_checkpoint_restores_onto_a_cuda_model(card):
    """The JAX package's checkpoint committed under tests/data (its bytes are
    held to the JAX package by test_torch_checkpoint.py) restores onto a
    model on the card bitwise as onto one on the CPU, and one training step
    from it agrees (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6)."""
    import os

    import numpy as np

    from mpi4dl_tpu_torch import cells as tc, layers as tl
    from mpi4dl_tpu_torch.checkpoint import CheckpointManager, state_leaves
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    fixture = os.path.join(os.path.dirname(__file__), "data", "jax_checkpoint")
    states, losses = [], []
    x = np.random.default_rng(4).standard_normal((4, 8, 8, 3)).astype(np.float32)
    for dev in ("cpu", card):
        model = tc.CellModel([
            tc.LayerCell([tl.Conv2d(3, 8, 3, bias=False, device=dev), tl.BatchNorm(8, device=dev),
                          tl.ReLU()]),
            tc.LayerCell([tl.GlobalAvgPool(), tl.Dense(8, 5, device=dev)]),
        ], (4, 8, 8, 3), 5)
        opt = Optimizer("sgd", lr=0.05, momentum=0.9)
        state, sid = CheckpointManager(fixture).restore_latest(TrainState.create(model, opt))
        assert sid == 1 and state.step == 1
        states.append([leaf.full() for leaf in state_leaves(state)])
        state, m = make_train_step(model, opt)(state, torch.from_numpy(x).to(dev),
                                               torch.arange(4, device=dev))
        losses.append(float(m["loss"]))
        states.append([leaf.full() for leaf in state_leaves(state)])
    for a, b in zip(states[0], states[2]):
        assert torch.equal(a, b)
    assert math.isclose(losses[0], losses[1], rel_tol=1e-5)
    for a, b in zip(states[1], states[3]):
        assert torch.allclose(a.double(), b.double(), rtol=1e-4, atol=1e-6)
