"""The port's data pipeline (mpi4dl_tpu_torch/data.py, utils/retry.py)
against the JAX package's (mpi4dl_tpu/data.py, utils/retry.py).

Every dataset's batches must be BITWISE equal to the JAX package's for the
same ``(seed, idx, batch_size)``: synthetic data, CIFAR-like data (the
synthetic fallback and real binary batches written here) and image folders
of PPM, BMP, ``.npy`` and raw RGB files written here.  ``prefetch_batches``
and ``retry_io`` are held to the JAX package's prefetch and retry cases
(tests/test_resilience.py:567-760, tests/test_obs.py:455-500): global-step
addressing, early exit and consumer exceptions stopping the producer, a
producer exception reaching the consumer, bounded exponential backoff that
re-raises the original exception.
"""

import os
import threading
import time

import numpy as np
import pytest

from mpi4dl_tpu import data as jdata
from mpi4dl_tpu.utils import retry_io as jretry_io
from mpi4dl_tpu_torch import data as tdata
from mpi4dl_tpu_torch.utils.retry import retry_io

CASES = [(0, 0, 2), (3, 5, 1), (7, 11, 4)]  # (seed, idx, batch_size)


def _write_ppm(path, img):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def _write_bmp(path, img):
    """24-bit uncompressed BMP, bottom-up rows padded to 4 bytes."""
    h, w = img.shape[:2]
    row = (3 * w + 3) & ~3
    size = 54 + row * h
    hdr = b"BM" + size.to_bytes(4, "little") + b"\0" * 4 + (54).to_bytes(4, "little")
    info = ((40).to_bytes(4, "little") + w.to_bytes(4, "little", signed=True)
            + h.to_bytes(4, "little", signed=True) + (1).to_bytes(2, "little")
            + (24).to_bytes(2, "little") + b"\0" * 24)
    body = b"".join(img[r, :, ::-1].tobytes().ljust(row, b"\0") for r in range(h - 1, -1, -1))
    with open(path, "wb") as f:
        f.write(hdr + info + body)


def _image_folder(root, seed=0):
    """Three classes of encoded and raw images of several sizes."""
    rng = np.random.default_rng(seed)
    img = lambda h, w: rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)  # noqa: E731
    for cls in ("a_ppm", "b_bmp", "c_raw"):
        os.makedirs(root / cls)
    _write_ppm(root / "a_ppm" / "0.ppm", img(20, 12))
    _write_ppm(root / "a_ppm" / "1.ppm", img(8, 8))
    _write_bmp(root / "b_bmp" / "0.bmp", img(16, 18))
    _write_bmp(root / "b_bmp" / "1.bmp", img(6, 9))
    np.save(root / "c_raw" / "0.npy", rng.random((14, 10, 3)).astype(np.float32))
    img(13, 13).tofile(root / "c_raw" / "1.rgb")
    return root


def _cifar_bin(root, n=5):
    d = root / "cifar-10-batches-bin"
    d.mkdir()
    rng = np.random.default_rng(1)
    for i in (1, 2):
        rng.integers(0, 256, size=(n, 3073), dtype=np.uint8).tofile(d / f"data_batch_{i}.bin")
    return root


def _pair(kind, root, seed):
    if kind == "synthetic":
        return (jdata.SyntheticDataset(16, 10, seed=seed),
                tdata.SyntheticDataset(16, 10, seed=seed))
    if kind == "cifar_fallback":
        return (jdata.CifarLikeDataset(str(root / "none"), 32, 10, seed),
                tdata.CifarLikeDataset(str(root / "none"), 32, 10, seed))
    if kind == "cifar_bin":
        _cifar_bin(root)
        return (jdata.CifarLikeDataset(str(root), 64, 10, seed),
                tdata.CifarLikeDataset(str(root), 64, 10, seed))
    if kind == "folder":
        _image_folder(root, seed)
        return (jdata.ImageFolderDataset(str(root), 10, 0, seed),
                tdata.ImageFolderDataset(str(root), 10, 0, seed))
    if kind == "empty_folder":
        return (jdata.ImageFolderDataset(str(root / "none"), 12, 0, seed),
                tdata.ImageFolderDataset(str(root / "none"), 12, 0, seed))
    raise ValueError(kind)


@pytest.mark.parametrize("seed,idx,bs", CASES)
@pytest.mark.parametrize("kind", ["synthetic", "cifar_fallback", "cifar_bin", "folder",
                                  "empty_folder"])
def test_batches_bitwise_equal_jax(tmp_path, kind, seed, idx, bs):
    want_ds, got_ds = _pair(kind, tmp_path, seed)
    assert len(got_ds) == len(want_ds)
    assert getattr(got_ds, "num_classes", None) == getattr(want_ds, "num_classes", None)
    (wx, wy), (gx, gy) = want_ds.batch(idx, bs), got_ds.batch(idx, bs)
    assert gx.dtype == wx.dtype == np.float32 and gy.dtype == wy.dtype == np.int32
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("app", [1, 2, 3])
def test_make_dataset_and_iterate_match_jax(tmp_path, app):
    from mpi4dl_tpu.config import ParallelConfig as JCfg
    from mpi4dl_tpu_torch.config import ParallelConfig as TCfg

    _image_folder(tmp_path)
    kw = dict(app=app, datapath=str(tmp_path), image_size=16, num_classes=3, seed=4)
    want, got = jdata.make_dataset(JCfg(**kw)), tdata.make_dataset(TCfg(**kw))
    assert type(got).__name__ == type(want).__name__
    for (wx, wy), (gx, gy) in zip(jdata.iterate(want, 2, 3), tdata.iterate(got, 2, 3)):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


# ---------------------------------------------------------------------------
# prefetch_batches and the retry discipline.
# ---------------------------------------------------------------------------


class _Stub:
    def batch(self, i, bs):
        return (np.full((bs, 2), i, np.float32), np.zeros((bs,), np.int32))


class _Flaky:
    def __init__(self, failures, exc=OSError):
        self.failures, self.exc, self.calls = failures, exc, 0

    def batch(self, idx, bs):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.exc(f"transient I/O #{self.calls}")
        return np.zeros((bs, 2), np.float32), np.zeros((bs,), np.int32)


def _wait_threads(n0: int, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if threading.active_count() <= n0:
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("workers", [0, 1, 2])
def test_prefetch_global_step_addressing_matches_jax(workers):
    seen = {"jax": [], "torch": []}

    def rec(key):
        class _Rec:
            def batch(self, idx, bs):
                seen[key].append(idx)
                return np.full((bs, 1), idx, np.float32), np.zeros((bs,), np.int32)
        return _Rec()

    got = [(g, x.copy()) for g, (x, _) in tdata.prefetch_batches(
        rec("torch"), 2, 6, 10, index_of=lambda g: g % 4, num_workers=workers)]
    want = [(g, x.copy()) for g, (x, _) in jdata.prefetch_batches(
        rec("jax"), 2, 6, 10, index_of=lambda g: g % 4, num_workers=workers)]
    assert [g for g, _ in got] == [g for g, _ in want] == [6, 7, 8, 9]
    assert seen["torch"] == seen["jax"] == [2, 3, 0, 1]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_prefetch_early_exit_stops_producer():
    n0 = threading.active_count()
    gen = tdata.prefetch_batches(_Stub(), 4, 0, 10_000, num_workers=2)
    next(gen)
    gen.close()
    assert _wait_threads(n0), "producer thread did not terminate"


def test_prefetch_consumer_exception_stops_producer():
    n0 = threading.active_count()
    with pytest.raises(RuntimeError):
        for i, _ in enumerate(tdata.prefetch_batches(_Stub(), 4, 0, 10_000,
                                                     num_workers=1)):
            if i == 2:
                raise RuntimeError("mid-epoch failure")
    assert _wait_threads(n0), "producer thread did not terminate"


@pytest.mark.parametrize("workers", [0, 1])
def test_prefetch_forwards_producer_exception(workers):
    n0 = threading.active_count()
    ds = _Flaky(99, exc=ValueError)
    with pytest.raises(ValueError, match="#1"):
        list(tdata.prefetch_batches(ds, 4, 0, 5, num_workers=workers))
    assert ds.calls == 1  # not an I/O error: no retry
    assert _wait_threads(n0), "producer thread did not terminate"


def test_prefetch_retries_through_producer_thread():
    ds = _Flaky(1)
    items = list(tdata.prefetch_batches(ds, 4, 0, 3, num_workers=1, backoff=0.01))
    assert [g for g, _ in items] == [0, 1, 2]


def test_fetch_batch_retry_bounded_and_original_exception():
    ds = _Flaky(2)
    sleeps = []
    x, _ = tdata.fetch_batch_with_retry(ds, 0, 4, retries=2, backoff=0.05,
                                        _sleep=sleeps.append)
    assert x.shape == (4, 2) and ds.calls == 3 and sleeps == [0.05, 0.1]
    ds = _Flaky(99)
    with pytest.raises(OSError, match="transient I/O #1"):
        tdata.fetch_batch_with_retry(ds, 0, 4, retries=2, _sleep=lambda s: None)
    assert ds.calls == 3
    ds = _Flaky(99, exc=ValueError)
    with pytest.raises(ValueError):
        tdata.fetch_batch_with_retry(ds, 0, 4, retries=5, _sleep=lambda s: None)
    assert ds.calls == 1


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_retry_io_bounded_backoff_and_original_exception(impl):
    """The same calls give the same sleeps, attempts and exceptions in both
    packages."""
    retry = jretry_io if impl == "jax" else retry_io

    def flaky(n_fail, exc):
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] <= n_fail:
                raise exc
            return 42
        fn.calls = calls
        return fn

    sleeps = []
    assert retry(flaky(2, OSError("x")), retries=2, backoff=0.05,
                 _sleep=sleeps.append) == 42
    assert sleeps == [0.05, 0.1]
    first = OSError("the FIRST failure")
    always = flaky(99, first)
    with pytest.raises(OSError, match="the FIRST failure"):
        retry(always, retries=2, _sleep=lambda s: None)
    assert always.calls["n"] == 3
    bad = flaky(99, ValueError("logic bug"))
    with pytest.raises(ValueError):
        retry(bad, retries=5, _sleep=lambda s: None)
    assert bad.calls["n"] == 1
    gone = flaky(99, FileNotFoundError("gone"))
    with pytest.raises(FileNotFoundError):
        retry(gone, retries=5, no_retry=(FileNotFoundError,), _sleep=lambda s: None)
    assert gone.calls["n"] == 1
