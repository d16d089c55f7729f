"""K3 of the PyTorch port (mpi4dl_tpu_torch/ops/flash_attention.py) against
the JAX package's Pallas block-flash kernel (mpi4dl_tpu/ops/pallas_attention.py).

On the CPU the port's wrapper runs its plain version and the JAX kernel runs
in interpret mode, as tests/test_pallas_attention.py runs it.  Inputs are
made with numpy from a seed.  Tolerances are the JAX tests': values
rtol/atol 1e-5 (test_pallas_attention.py:35-74), exact zeros for fully
masked rows (:77-89), gradients rtol 1e-4 / atol 1e-5 (:92-108).  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py; here a torch emulation of the
bf16 tensor-core kernels' rounding is held against JAX at the tolerances
the card checks state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.ops import pallas_attention as jpa
from mpi4dl_tpu_torch.ops import flash_attention as fa


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _close(got, want, rtol=1e-5, atol=1e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol, atol=atol)


# The kernel registry's two cases (mpi4dl_tpu/ops/kernel_registry.py:76-106),
# and a causal ring hop with offsets: (dtype, causal, q_off, k_off).
@pytest.mark.parametrize("dtype,causal,q_off,k_off", [
    ("float32", False, 0, 0),
    ("bfloat16", True, 0, 0),
    ("float32", True, 256, 100),
])
def test_block_flash_plain_matches_pallas(dtype, causal, q_off, k_off):
    q, k, v = _arrays((2, 48, 64), (2, 300, 64), (2, 300, 64))
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = jpa.block_flash(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                           jnp.asarray(q_off, jnp.int32), jnp.asarray(k_off, jnp.int32),
                           causal, 0.125, 16, 128, True)
    before = dict(fa.LAUNCHES)
    got = fa.block_flash(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                         q_off, k_off, causal, 0.125)
    assert fa.LAUNCHES == before  # CPU tensors take the plain version
    assert [tuple(g.shape) for g in got] == [(2, 48, 64), (2, 48), (2, 48)]
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, want)


def test_fully_masked_rows_are_exact_zeros():
    """A causal block whose keys all lie in the future gives l = o = 0 and
    m = NEG_INF exactly (the guard the ring merge relies on)."""
    q, k, v = _arrays((1, 16, 8), (1, 16, 8), (1, 16, 8))
    args = (0, 1000, True, 1.0 / 8 ** 0.5)
    o, m, l = fa.block_flash(_torch(q), _torch(k), _torch(v), *args)
    jo, jm, jl = jpa.block_flash(_jax(q), _jax(k), _jax(v), jnp.asarray(0),
                                 jnp.asarray(1000), True, args[3], 256, 512, True)
    np.testing.assert_array_equal(l.numpy(), 0.0)
    np.testing.assert_array_equal(o.numpy(), 0.0)
    np.testing.assert_array_equal(m.numpy(), np.float32(fa.NEG_INF))
    np.testing.assert_array_equal(np.asarray(jl), 0.0)
    np.testing.assert_array_equal(np.asarray(jm), m.numpy())


def test_merge_of_two_halves_equals_the_full_block():
    b, t, h, d = 2, 32, 2, 16
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(b * h, t, d)
               for x in _arrays(*[(b, t, h, d)] * 3))
    sc = 1.0 / d ** 0.5
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    full = fa.block_flash(tq, tk, tv, 0, 0, False, sc)
    merged = fa.mlo_merge(fa.block_flash(tq, tk[:, :t // 2], tv[:, :t // 2], 0, 0, False, sc),
                          fa.block_flash(tq, tk[:, t // 2:], tv[:, t // 2:], 0, t // 2,
                                         False, sc))
    _close(merged, full)
    z = jnp.zeros((), jnp.int32)
    jmerged = jpa.mlo_merge(
        jpa.block_flash(_jax(q), _jax(k[:, :t // 2]), _jax(v[:, :t // 2]), z, z,
                        False, sc, 256, 512, True),
        jpa.block_flash(_jax(q), _jax(k[:, t // 2:]), _jax(v[:, t // 2:]), z,
                        jnp.asarray(t // 2), False, sc, 256, 512, True))
    _close(merged, jmerged)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_local_matches_pallas(causal):
    q, k, v = _arrays(*[(2, 48, 2, 32)] * 3)
    want = jpa.flash_attention_local(_jax(q), _jax(k), _jax(v), causal=causal,
                                     interpret=True)
    got = fa.flash_attention_local(_torch(q), _torch(k), _torch(v), causal=causal)
    assert got.shape == (2, 48, 2, 32) and got.dtype == torch.float32
    _close([got], [want])


def test_flash_attention_local_unaligned_shapes():
    """T and D off every tile grid (test_pallas_attention.py:45-53)."""
    q, k, v = _arrays(*[(2, 50, 2, 24)] * 3)
    want = jpa.flash_attention_local(_jax(q), _jax(k), _jax(v), interpret=True)
    _close([fa.flash_attention_local(_torch(q), _torch(k), _torch(v))], [want])


@pytest.mark.parametrize("t_k", [40, 1100])
def test_gradients_match_jax(t_k):
    """Grads through the autograd Function against JAX's custom VJP; at
    Tk = 1100 the backward splits the keys into three even tiles."""
    q, k, v = _arrays((2, 40, 16), (2, t_k, 16), (2, t_k, 16), seed=1)
    args = (7, 3, True, 0.25)   # a causal hop with offsets

    def loss_jax(q, k, v):
        o, m, l = jpa.block_flash(q, k, v, jnp.asarray(args[0]), jnp.asarray(args[1]),
                                  args[2], args[3], 256, 512, True)
        return jnp.sum(o ** 2) + jnp.sum(jnp.sin(l))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    tq, tk, tv = (_torch(x).requires_grad_() for x in (q, k, v))
    o, m, l = fa.block_flash_t(tq, tk, tv, *args)
    ((o ** 2).sum() + torch.sin(l).sum()).backward()
    _close([tq.grad, tk.grad, tv.grad], want, rtol=1e-4, atol=1e-5)


def test_flash_attention_local_gradients_match_jax():
    q, k, v = _arrays(*[(2, 40, 2, 16)] * 3)

    def loss_jax(q, k, v):
        return jnp.sum(jpa.flash_attention_local(q, k, v, causal=True, interpret=True) ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    ts = [_torch(x).requires_grad_() for x in (q, k, v)]
    (fa.flash_attention_local(*ts, causal=True) ** 2).sum().backward()
    _close([t.grad for t in ts], want, rtol=1e-4, atol=1e-5)


def test_no_kernel_for_other_devices():
    q = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.block_flash(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.block_flash_bwd(q, q, q, q[..., 0], q, q[..., 0])
    fa.reset_launch_counts()
    assert fa.LAUNCHES == {"block_flash": 0, "block_flash_bwd": 0}


# K3's backward and the tensor-core kernel's rounding.  The CUDA kernels
# take bf16 q, k and v; JAX is given the same values in fp32 (bf16 values
# are exact in fp32), so both sides compute the fp32 gradients of the same
# block and the JAX gradient test's tolerance applies before any cast.
# (Tq, Tk, D, causal, q_off, k_off): the card test's trap shapes (Tq 77,
# Tk 201, D 40 and D 100), a causal hop with offsets, a D off the 8-grid,
# and a block wholly in the future (every row masked).
BWD_CASES = [
    (77, 201, 40, True, 0, 0),
    (48, 300, 64, False, 0, 0),
    (64, 130, 100, True, 300, 100),
    (50, 90, 33, True, 20, 0),
    (40, 70, 40, True, 0, 500),
]


def _bf16_inputs(t_q, t_k, d, seed=2):
    q, k, v, do = _arrays((2, t_q, d), (2, t_k, d), (2, t_k, d), (2, t_q, d), seed=seed)
    dl = _arrays((2, t_q), seed=seed + 1)[0]
    q, k, v = (_torch(x, torch.bfloat16) for x in (q, k, v))
    return q, k, v, _torch(do), _torch(dl)


def _jax_vjp(q, k, v, do, dl, q_off, k_off, causal, scale):
    """JAX's forward state and custom-VJP gradients on q, k, v's values."""
    def f(q, k, v):
        return jpa.block_flash(q, k, v, jnp.asarray(q_off, jnp.int32),
                               jnp.asarray(k_off, jnp.int32), causal, scale,
                               256, 512, True)

    qj, kj, vj = (_jax(x.float().numpy()) for x in (q, k, v))
    state, vjp = jax.vjp(f, qj, kj, vj)
    grads = vjp((_jax(do.numpy()), jnp.zeros_like(state[1]), _jax(dl.numpy())))
    return state, grads


def _close_scaled(got, want, rtol=1e-4, atol=1e-5):
    """rtol, and atol scaled by max|ref|: the tolerance the card holds the
    bf16 kernels to (tests/test_pallas_attention.py:92-108's on unit-scale
    gradients); a zero reference must be matched exactly."""
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        big = float(np.abs(w).max())
        if big == 0.0:
            np.testing.assert_array_equal(g, 0.0)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * big)


@pytest.mark.parametrize("t_q,t_k,d,causal,q_off,k_off", BWD_CASES)
def test_block_flash_bwd_plain_matches_jax_vjp(t_q, t_k, d, causal, q_off, k_off):
    q, k, v, do, dl = _bf16_inputs(t_q, t_k, d)
    scale = d ** -0.5
    (_, jm, _), want = _jax_vjp(q, k, v, do, dl, q_off, k_off, causal, scale)
    _, m, _ = fa.block_flash_plain(q, k, v, q_off, k_off, causal, scale)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
    got = fa.block_flash_bwd_plain(q, k, v, m, do, dl, q_off, k_off, causal, scale)
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, want, rtol=1e-4, atol=1e-5)


def _split(x):
    """x (fp32) as bf16 hi + lo, each held in fp32: the kernels' split."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _tc_scores(q, k, q_off, k_off, causal, scale):
    """s as the tensor-core kernels form it: exact bf16 operands, an fp32
    sum, the scale on the sum, masked keys set to NEG_INF after scaling."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(~fa._causal_mask(q.shape[1], k.shape[1], q_off, k_off, "cpu"),
                          fa.NEG_INF)
    return s


def _tc_forward(q, k, v, q_off, k_off, causal, scale):
    s = _tc_scores(q, k, q_off, k_off, causal, scale)
    m = s.amax(dim=-1)
    p = torch.where(s > fa.NEG_INF * 0.5, torch.exp(s - m[..., None]), 0.0)
    ph, pl = _split(p)
    vf = v.float()
    return ph @ vf + pl @ vf, m, p.sum(dim=-1)


def _tc_backward(q, k, v, m, do, dl, q_off, k_off, causal, scale):
    s = _tc_scores(q, k, q_off, k_off, causal, scale)
    p = torch.where(s > fa.NEG_INF * 0.5, torch.exp(s - m[..., None]), 0.0)
    qf, kf, vf = q.float(), k.float(), v.float()
    dh, dlo = _split(do)
    ds = p * (dh @ vf.transpose(1, 2) + dlo @ vf.transpose(1, 2) + dl[..., None])
    ph, pl = _split(p)
    sh, sl = _split(ds)
    dv = ph.transpose(1, 2) @ dh + pl.transpose(1, 2) @ dh + ph.transpose(1, 2) @ dlo
    dk = (sh.transpose(1, 2) @ qf + sl.transpose(1, 2) @ qf) * scale
    dq = (sh @ kf + sl @ kf) * scale
    return dq, dk, dv


@pytest.mark.parametrize("t_q,t_k,d,causal,q_off,k_off", BWD_CASES)
def test_tensor_core_rounding_holds_the_stated_tolerances(t_q, t_k, d, causal, q_off, k_off):
    """The bf16 kernels' rounding (scale on the fp32 scores; P, dS and dô
    as bf16 hi + lo pairs; dv without lo x lo), emulated in fp32 torch ops,
    against JAX: the forward within 1e-5·max(1, max|ref|) on m and o/l and
    rtol 1e-5 on l, exact (0, NEG_INF, 0) rows where all keys are masked;
    the gradients within rtol 1e-4 / atol 1e-5·max|ref|."""
    q, k, v, do, dl = _bf16_inputs(t_q, t_k, d, seed=5)
    scale = d ** -0.5
    (jo, jm, jl), want = _jax_vjp(q, k, v, do, dl, q_off, k_off, causal, scale)
    jo, jm, jl = (torch.from_numpy(np.array(x, np.float32)) for x in (jo, jm, jl))
    o, m, l = _tc_forward(q, k, v, q_off, k_off, causal, scale)
    live = jm > fa.NEG_INF * 0.5
    assert torch.equal(live, m > fa.NEG_INF * 0.5)
    assert bool((m[~live] == fa.NEG_INF).all() and (l[~live] == 0).all()
                and (o[~live] == 0).all())
    if live.any():
        assert float((m - jm)[live].abs().max()) <= 1e-5 * max(1.0, float(jm[live].abs().max()))
        assert float(((l - jl).abs() / jl)[live].max()) <= 1e-5
        on, jon = o / l.clamp_min(1e-30)[..., None], jo / jl.clamp_min(1e-30)[..., None]
        assert float((on - jon).abs().max()) <= 1e-5 * max(1.0, float(jon.abs().max()))
    _close_scaled(_tc_backward(q, k, v, m, do, dl, q_off, k_off, causal, scale), want)


def test_cpu_tensors_take_the_plain_backward():
    """block_flash_bwd on CPU tensors is block_flash_bwd_plain, bitwise, and
    launches nothing; block_flash_t's gradients come back in the inputs'
    dtypes."""
    q, k, v, do, dl = _bf16_inputs(40, 90, 32)
    args = (7, 3, True, 0.25)
    _, m, _ = fa.block_flash(q, k, v, *args)
    before = dict(fa.LAUNCHES)
    got = fa.block_flash_bwd(q, k, v, m, do, dl, *args)
    want = fa.block_flash_bwd_plain(q, k, v, m, do, dl, *args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    o, _, l = fa.block_flash_t(*ts, *args)
    ((o * do).sum() + (l * dl).sum()).backward()
    assert fa.LAUNCHES == before
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16
        assert torch.equal(t.grad, w.to(torch.bfloat16))


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Both kernel sources include csrc/sm90_mma.cuh; an edit of the header
    rebuilds them (the library's name hashes the headers too)."""
    from mpi4dl_tpu_torch.ops import _build

    for name in _build.SOURCES:
        assert '#include "sm90_mma.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
