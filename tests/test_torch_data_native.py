"""The port's native loader bridge (mpi4dl_tpu_torch/data_native.py over
native/tileloader.cc): the cases of tests/test_data_native.py, each also
held BITWISE to the JAX package's bridge (mpi4dl_tpu/data_native.py) on the
same file.  The port builds its own library under build/native."""

import os

import numpy as np
import pytest

from mpi4dl_tpu import data_native as jax_native
from mpi4dl_tpu_torch import data_native


def _same_as_jax(fn_name, *args):
    """The port's result of ``fn_name(*args)``, asserted bitwise equal to
    the JAX package's."""
    got = getattr(data_native, fn_name)(*args)
    want = getattr(jax_native, fn_name)(*args)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    return got


@pytest.fixture(scope="module")
def lib_ok():
    if not data_native.available():
        pytest.skip("native tileloader unavailable (no g++)")
    assert str(data_native.library_path()).startswith(
        str(data_native.ROOT / "build" / "native"))
    assert data_native.codecs() == jax_native.codecs()
    return True


def _write_rgb(path, side, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(side, side, 3), dtype=np.uint8)
    raw.tofile(path)
    return raw


def test_load_rgb_center_crop(tmp_path, lib_ok):
    p = str(tmp_path / "img.rgb")
    raw = _write_rgb(p, 16)
    out = _same_as_jax("load_rgb", p, 8)
    assert out is not None and out.shape == (8, 8, 3)
    want = raw[4:12, 4:12].astype(np.float32) / 255.0
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_load_rgb_tile_up(tmp_path, lib_ok):
    p = str(tmp_path / "img.rgb")
    raw = _write_rgb(p, 4)
    out = _same_as_jax("load_rgb", p, 8)
    assert out is not None
    want = np.tile(raw.astype(np.float32) / 255.0, (2, 2, 1))
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_load_batch(tmp_path, lib_ok):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"im{i}.rgb")
        _write_rgb(p, 8, seed=i)
        paths.append(p)
    out = _same_as_jax("load_batch", paths, 8)
    assert out is not None and out.shape == (3, 8, 8, 3)
    for i, p in enumerate(paths):
        np.testing.assert_allclose(out[i], data_native.load_rgb(p, 8), atol=0)


def test_crop_tiles_matches_numpy(lib_ok):
    rng = np.random.default_rng(0)
    batch = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    for row in range(2):
        for col in range(3):
            got = _same_as_jax("crop_tiles", batch, row, col, 2, 3)
            want = batch[:, row * 4 : (row + 1) * 4, col * 4 : (col + 1) * 4]
            np.testing.assert_array_equal(got, want)


def test_image_folder_uses_native(tmp_path, lib_ok):
    from mpi4dl_tpu.data import ImageFolderDataset as JFolder
    from mpi4dl_tpu_torch.data import ImageFolderDataset

    cdir = tmp_path / "class_a"
    os.makedirs(cdir)
    _write_rgb(str(cdir / "a.rgb"), 8)
    ds = ImageFolderDataset(str(tmp_path), image_size=8)
    x, y = ds.batch(0, 2)
    assert x.shape == (2, 8, 8, 3) and y.shape == (2,)
    assert x.dtype == np.float32
    np.testing.assert_array_equal(x, JFolder(str(tmp_path), image_size=8).batch(0, 2)[0])


# --- Encoded formats ---

# PIL is used only to AUTHOR test fixtures (and as a reference decoder);
# the library itself never requires it.
PIL_Image = pytest.importorskip("PIL.Image", reason="PIL needed to author encoded fixtures")


def _rand_img(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def _write_ppm(path, img):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n# comment\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def test_native_ppm_exact(tmp_path, lib_ok):
    img = _rand_img(12, 8, seed=1)  # rectangular: crop W, tile H
    p = str(tmp_path / "img.ppm")
    _write_ppm(p, img)
    out = _same_as_jax("load_image", p, 8)
    assert out is not None and out.shape == (8, 8, 3)
    want = img[:, 2:10].astype(np.float32) / 255.0
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_native_bmp_exact(tmp_path, lib_ok):
    Image = PIL_Image
    img = _rand_img(8, 8, seed=2)
    p = str(tmp_path / "img.bmp")
    Image.fromarray(img).save(p, format="BMP")
    out = _same_as_jax("load_image", p, 8)
    assert out is not None
    np.testing.assert_allclose(out, img.astype(np.float32) / 255.0, atol=1e-6)


def test_native_png_exact(tmp_path, lib_ok):
    if not data_native.codecs()["png"]:
        pytest.skip("native build lacks libpng")
    Image = PIL_Image
    img = _rand_img(10, 6, seed=3)
    p = str(tmp_path / "img.png")
    Image.fromarray(img).save(p, format="PNG")
    out = _same_as_jax("load_image", p, 6)
    assert out is not None
    want = img[:, 2:8].astype(np.float32) / 255.0  # PNG lossless: exact
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_native_jpeg_close_to_pil(tmp_path, lib_ok):
    if not data_native.codecs()["jpeg"]:
        pytest.skip("native build lacks libjpeg")
    Image = PIL_Image
    img = _rand_img(16, 16, seed=4)
    p = str(tmp_path / "img.jpg")
    Image.fromarray(img).save(p, format="JPEG", quality=95)
    out = _same_as_jax("load_image", p, 16)
    assert out is not None
    # Different libjpeg builds may differ by a few IDCT rounding steps.
    pil = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
    np.testing.assert_allclose(out, pil, atol=0.05)


def test_image_folder_end_to_end_encoded(tmp_path, lib_ok):
    """End-to-end: a real encoded image folder (JPEG + PNG + PPM classes)
    loads through ImageFolderDataset into training batches."""
    Image = PIL_Image

    from mpi4dl_tpu.data import ImageFolderDataset as JFolder
    from mpi4dl_tpu_torch.data import ImageFolderDataset

    for label, (cls, ext, fmt) in enumerate(
        [("cats", ".jpg", "JPEG"), ("dogs", ".png", "PNG"), ("owls", ".ppm", None)]
    ):
        d = tmp_path / cls
        d.mkdir()
        img = _rand_img(20, 20, seed=10 + label)
        if fmt is None:
            _write_ppm(str(d / f"a{ext}"), img)
        else:
            Image.fromarray(img).save(str(d / f"a{ext}"), format=fmt)
    ds = ImageFolderDataset(str(tmp_path), image_size=16)
    assert len(ds) == 3 and ds.num_classes == 3
    x, y = ds.batch(0, 3)
    assert x.shape == (3, 16, 16, 3) and x.dtype == np.float32
    assert sorted(y.tolist()) == [0, 1, 2]
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert x.std() > 0.1  # real pixel content, not zeros
    wx, wy = JFolder(str(tmp_path), image_size=16).batch(0, 3)
    np.testing.assert_array_equal(x, wx)
    np.testing.assert_array_equal(y, wy)


def test_native_corrupt_files_degrade_gracefully(tmp_path, lib_ok):
    """Truncated/corrupt encoded files must return None (error code), never
    crash the process — pins the setjmp error paths in decode_jpeg/png."""
    Image = PIL_Image
    img = _rand_img(32, 32, seed=9)
    for ext, fmt in ((".jpg", "JPEG"), (".png", "PNG"), (".bmp", "BMP")):
        p = tmp_path / f"full{ext}"
        Image.fromarray(img).save(str(p), format=fmt)
        data = p.read_bytes()
        trunc = tmp_path / f"trunc{ext}"
        trunc.write_bytes(data[: len(data) // 3])
        assert _same_as_jax("load_image", str(trunc), 16) is None
    bad_ppm = tmp_path / "bad.ppm"
    bad_ppm.write_bytes(b"P6\n8 8\n255\n" + b"\x00" * 10)  # too few pixels
    assert _same_as_jax("load_image", str(bad_ppm), 8) is None
    crlf_ppm = tmp_path / "crlf.ppm"
    img8 = _rand_img(8, 8, seed=11)
    crlf_ppm.write_bytes(b"P6\r\n8 8\r\n255\r\n" + img8.tobytes())
    out = _same_as_jax("load_image", str(crlf_ppm), 8)
    assert out is not None  # CRLF header: "\r\n" counts as ONE separator
    np.testing.assert_allclose(out, img8.astype(np.float32) / 255.0, atol=1e-6)
