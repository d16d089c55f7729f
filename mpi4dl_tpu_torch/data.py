"""Data pipelines (counterpart of ``mpi4dl_tpu/data.py``): the reference's
three APP modes, 1 = image folder, 2 = CIFAR-10-like, 3 = synthetic.  All
yield NHWC float32 numpy batches and int32 labels, bitwise equal to the JAX
package's for the same ``(seed, idx, batch_size)`` (the same
``np.random.default_rng`` calls in the same order).  Batches stay on the
host here; the runner moves them to the device.  The image-folder path
decodes with the native loader (``data_native.py``), then PIL, then numpy.
"""

from __future__ import annotations

import dataclasses
import math
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticDataset:
    """APP=3: random images, fixed by seed (reference: torch.randn synthetic
    "times=dataset size 10*batch" loop)."""

    image_size: int
    num_classes: int
    length: int = 320
    channels: int = 3
    seed: int = 0

    def __len__(self) -> int:
        return self.length

    def batch(self, idx: int, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed + idx)
        x = rng.standard_normal(
            (batch_size, self.image_size, self.image_size, self.channels),
            dtype=np.float32,
        )
        y = rng.integers(0, self.num_classes, size=(batch_size,), dtype=np.int32)
        return x, y


@dataclasses.dataclass
class CifarLikeDataset:
    """APP=2: CIFAR-10 shaped data.  Loads real CIFAR-10 binary batches when
    `datapath` contains them; otherwise falls back to deterministic synthetic
    32x32 data (keeps tests hermetic — no downloads, zero egress)."""

    datapath: str = "./data"
    image_size: int = 32
    num_classes: int = 10
    seed: int = 0

    def __post_init__(self):
        self._data: Optional[Tuple[np.ndarray, np.ndarray]] = None
        bin_path = os.path.join(self.datapath, "cifar-10-batches-bin")
        if os.path.isdir(bin_path):
            xs, ys = [], []
            for i in range(1, 6):
                f = os.path.join(bin_path, f"data_batch_{i}.bin")
                if not os.path.exists(f):
                    continue
                raw = np.fromfile(f, dtype=np.uint8).reshape(-1, 3073)
                ys.append(raw[:, 0].astype(np.int32))
                x = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                xs.append(x.astype(np.float32) / 255.0)
            if xs:
                self._data = (np.concatenate(xs), np.concatenate(ys))

    def __len__(self) -> int:
        return len(self._data[0]) if self._data is not None else 50000

    def batch(self, idx: int, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._data is None:
            rng = np.random.default_rng(self.seed + idx)
            x = rng.standard_normal(
                (batch_size, self.image_size, self.image_size, 3), dtype=np.float32
            )
            y = rng.integers(0, self.num_classes, size=(batch_size,), dtype=np.int32)
            return x, y
        x, y = self._data
        start = (idx * batch_size) % (len(x) - batch_size + 1)
        xb = x[start : start + batch_size]
        if self.image_size != 32:
            reps = self.image_size // 32
            xb = np.tile(xb, (1, reps, reps, 1))[:, : self.image_size, : self.image_size]
        return xb, y[start : start + batch_size]


ENCODED_EXTS = (".ppm", ".bmp", ".jpg", ".jpeg", ".png")
RAW_EXTS = (".npy", ".rgb", ".bin")


@dataclasses.dataclass
class ImageFolderDataset:
    """APP=1: directory-per-class image folder — the reference reads real
    encoded images through torchvision ImageFolder
    (benchmark_amoebanet_sp.py:264-283).  Decode chain per file:

    1. native C++ loader (PPM/BMP built in; JPEG/PNG via system libjpeg /
       libpng when present at build time) — native/tileloader.cc;
    2. PIL, when importable (covers any remaining encoded format);
    3. raw .npy / interleaved-RGB bytes (pure numpy, always works).
    """

    datapath: str
    image_size: int
    num_classes: int = 0
    seed: int = 0

    def __post_init__(self):
        self._files = []
        if os.path.isdir(self.datapath):
            classes = sorted(
                d for d in os.listdir(self.datapath)
                if os.path.isdir(os.path.join(self.datapath, d))
            )
            for label, cls in enumerate(classes):
                cdir = os.path.join(self.datapath, cls)
                for fn in sorted(os.listdir(cdir)):
                    if fn.lower().endswith(RAW_EXTS + ENCODED_EXTS):
                        self._files.append((os.path.join(cdir, fn), label))
            if self.num_classes == 0:
                self.num_classes = max(1, len(classes))
        if self.num_classes == 0:
            self.num_classes = 10

    def __len__(self) -> int:
        return max(len(self._files), 1)

    def _fit(self, img: np.ndarray) -> np.ndarray:
        """Center-crop or tile an [H, W, 3] float image to the square target."""
        h, w = img.shape[:2]
        if h > self.image_size:
            o = (h - self.image_size) // 2
            img = img[o : o + self.image_size]
        if w > self.image_size:
            o = (w - self.image_size) // 2
            img = img[:, o : o + self.image_size]
        h, w = img.shape[:2]
        if h < self.image_size or w < self.image_size:
            reps_h = -(-self.image_size // h)
            reps_w = -(-self.image_size // w)
            img = np.tile(img, (reps_h, reps_w, 1))[
                : self.image_size, : self.image_size
            ]
        return np.asarray(img, np.float32)

    def _load(self, path: str) -> np.ndarray:
        from mpi4dl_tpu_torch import data_native

        low = path.lower()
        if low.endswith(".npy"):
            return self._fit(np.load(path))
        if low.endswith(ENCODED_EXTS):
            native = data_native.load_image(path, self.image_size)
            if native is not None:
                return native
            try:  # PIL fallback (not a hard dependency)
                from PIL import Image

                with Image.open(path) as im:
                    arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
                return self._fit(arr)
            except ImportError:
                raise RuntimeError(
                    f"cannot decode {path!r}: the native build lacks this "
                    "codec and PIL is not importable"
                )
        native = data_native.load_rgb(path, self.image_size)
        if native is not None:
            return native
        raw = np.fromfile(path, dtype=np.uint8)
        side = int(math.isqrt(raw.size // 3))
        img = raw[: side * side * 3].reshape(side, side, 3).astype(np.float32) / 255.0
        return self._fit(img)

    def batch(self, idx: int, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        if not self._files:
            rng = np.random.default_rng(self.seed + idx)
            x = rng.standard_normal(
                (batch_size, self.image_size, self.image_size, 3), dtype=np.float32
            )
            y = rng.integers(0, self.num_classes, size=(batch_size,), dtype=np.int32)
            return x, y
        xs, ys = [], []
        for i in range(batch_size):
            path, label = self._files[(idx * batch_size + i) % len(self._files)]
            xs.append(self._load(path))
            ys.append(label)
        return np.stack(xs), np.asarray(ys, np.int32)


def make_dataset(cfg):
    """APP-mode dispatch (reference benchmark scripts, e.g.
    benchmark_amoebanet_sp.py:264-306)."""
    if cfg.app == 1:
        return ImageFolderDataset(cfg.datapath, cfg.image_size, cfg.num_classes, cfg.seed)
    if cfg.app == 2:
        return CifarLikeDataset(cfg.datapath, cfg.image_size, cfg.num_classes, cfg.seed)
    return SyntheticDataset(cfg.image_size, cfg.num_classes, seed=cfg.seed)


def iterate(dataset, batch_size: int, steps: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    for i in range(steps):
        yield dataset.batch(i, batch_size)


def fetch_batch_with_retry(dataset, idx: int, batch_size: int, *,
                           retries: int = 2, backoff: float = 0.05,
                           _sleep=time.sleep) -> Tuple[np.ndarray, np.ndarray]:
    """``dataset.batch`` with bounded retry + exponential backoff around
    transient I/O errors (``OSError``: NFS blips, eviction races in the
    image-folder path), then fail-fast re-raising the ORIGINAL exception —
    instead of the producer's single-shot raise.  Non-I/O errors (bad
    shapes, logic bugs) propagate immediately: retrying those only delays
    the crash.  The retry discipline is :func:`utils.retry.retry_io`,
    shared with the checkpoint layer."""
    from mpi4dl_tpu_torch.utils.retry import retry_io

    return retry_io(
        lambda: dataset.batch(idx, batch_size),
        retries=retries, backoff=backoff, _sleep=_sleep,
    )


def prefetch_batches(
    dataset,
    batch_size: int,
    start: int,
    stop: int,
    *,
    index_of: Optional[Callable[[int], int]] = None,
    num_workers: int = 0,
    retries: int = 2,
    backoff: float = 0.05,
    stall_hook: Optional[Callable[[int], float]] = None,
) -> Iterator[Tuple[int, Tuple[np.ndarray, np.ndarray]]]:
    """Yield ``(gstep, (x, y))`` for global steps in ``[start, stop)``;
    the dataset index is ``index_of(gstep)`` (identity by default — the
    supervised loop passes ``g % steps_per_epoch``).

    ``num_workers > 0`` prefetches on a background thread (the reference's
    DataLoader num_workers analog).  Early consumer exit (exception
    mid-epoch, generator close, rollback reopening past a poison batch)
    must not strand the producer: a plain ``q.put`` on a full queue would
    block forever holding batch memory once nobody drains it.  The producer
    therefore puts with a timeout while polling a stop event, and the
    generator's ``finally`` sets the event and drains the queue so the
    thread always terminates.  A producer-side exception rides the queue as
    a sentinel and re-raises in the consumer — a dead producer must not
    leave the consumer blocked on ``q.get()``.

    ``stall_hook(gstep)`` (fault injection) returns seconds to sleep before
    producing that batch — the watchdog's test stimulus.
    """
    idx_of = index_of if index_of is not None else (lambda g: g)

    def fetch(g: int) -> Tuple[np.ndarray, np.ndarray]:
        if stall_hook is not None:
            delay = stall_hook(g)
            if delay:
                time.sleep(delay)
        return fetch_batch_with_retry(
            dataset, idx_of(g), batch_size, retries=retries, backoff=backoff
        )

    if num_workers <= 0:
        for g in range(start, stop):
            yield g, fetch(g)
        return

    q: queue.Queue = queue.Queue(maxsize=max(2, num_workers))
    stop_evt = threading.Event()

    def _put(item) -> bool:
        while not stop_evt.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for g in range(start, stop):
                if stop_evt.is_set() or not _put((g, fetch(g))):
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            _put(e)
            return
        _put(None)  # end-of-stream sentinel

    t = threading.Thread(target=producer, daemon=True, name="mpi4dl-batches")
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop_evt.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
