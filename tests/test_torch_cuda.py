"""Card-only tests of the PyTorch port: the CUDA kernels against their plain
versions, and a reduced-depth training step through them.  They skip
without a CUDA card.  This file imports no JAX, so it runs on a machine
without it:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

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
    for dev in (card, torch.device("cpu")):
        ts = [x.to(dev).requires_grad_() for x in qkv]
        out = fa.flash_attention_local(*ts, causal=True)
        (out * out).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


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
