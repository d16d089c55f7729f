"""Checkpoint / resume (counterpart of ``mpi4dl_tpu/checkpoint.py``).

A training state is flattened to an ordered list of leaves; restore copies
the leaves back into a TEMPLATE state of the same structure (the state the
step builders made), in place, so no schema is serialized.  The two
on-disk formats are the JAX package's, byte for byte:

- **v1 (npz)**: one ``ckpt_<step>.npz`` holding every leaf as ``leaf_<i>``
  plus a ``__manifest__`` record (per-leaf CRC32, shape, dtype, step id,
  fingerprint).
- **v2 (sharded, the default)**: a directory ``ckpt_<step>/`` with one raw
  file per shard, keyed by the shard's global offset, and a
  ``manifest.json`` (per-shard CRC32, offsets and shapes, the step id, the
  split identity/layout fingerprints).  Shard files and the manifest are
  fsync'd in a hidden temporary directory, which one atomic rename (and a
  fsync of the parent) publishes.

Leaf order.  For a :class:`~mpi4dl_tpu_torch.train.TrainState` it is
``jax.tree.leaves(TrainState(params, opt_state, step))`` of the JAX package
for the same model: the params pytree of :func:`params.layout_tensors`
(lists in order, dict keys sorted; running statistics sit in it), then the
optimizer state in ``Optimizer.init``'s order (``()``, ``(v,)`` or ``(m, v,
count)``, each slot a tree mirroring the params, fp32, zeros for running
statistics), then ``step`` as an int32 scalar.  So a single-device, DP or
SP checkpoint written by one package restores in the other.  bf16 leaves
are stored as their raw bytes with the dtype name ``bfloat16``, as the JAX
package stores them.  Other states flatten as JAX flattens a pytree (dicts
by sorted key, lists and tuples in order).  The port writes each leaf as
one shard; a leaf that the JAX package wrote in several shards (a sharded
``jax.Array``) is reassembled from their global offsets on restore.

Ranks.  With a process ``group``, every rank flattens the same leaf list;
a rank HOLDS a leaf when its tensor is not on the meta device (pipeline
stages release the others' cells) and, for an optimizer slot, when its
optimizer covers that parameter.  Each leaf is written by exactly one rank,
the lowest that holds it (replicas of DP and SP ranks are written once);
after the shard files are down, rank 0 alone writes the manifest and
publishes.  A pipeline checkpoint (one stage per rank) is thereby the
single-device layout of the whole model, not the JAX package's stacked
stage buffers.  Restore reads on each rank only the leaves it holds, and
the ranks agree on the checkpoint they restore.

Fingerprints (identity must match, layout may differ: elastic restore),
the manifest-first walk of ``restore_latest`` past torn or corrupt
checkpoints, pruning to the newest ``keep`` and the reclaiming of stranded
work directories are the JAX package's.
"""

from __future__ import annotations

import binascii
import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.utils.retry import retry_io

# Bounded-retry budget for checkpoint-file I/O (the data pipeline's retry
# discipline): shard writes and manifest and shard reads retry transient
# OSErrors with backoff before failing with the ORIGINAL exception.
_IO_RETRIES = 2
_IO_BACKOFF = 0.05

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")
_CKPT_DIR_RE = re.compile(r"^ckpt_(\d+)$")

MANIFEST_KEY = "__manifest__"
STEP_KEY = "__step_id__"
MANIFEST_SCHEMA = 1
MANIFEST_SCHEMA_V2 = 2
SHARD_MANIFEST = "manifest.json"

logger = logging.getLogger(__name__)


class CheckpointInvalid(ValueError):
    """A checkpoint failed validation (torn file or directory, CRC mismatch,
    missing shard files, or a fingerprint mismatch)."""


class CheckpointMismatch(CheckpointInvalid):
    """The checkpoint is intact but belongs to a DIFFERENT program (model
    identity fingerprint, leaf count or leaf shapes disagree).  A mismatch
    is deterministic user error: ``restore_latest`` raises it rather than
    start afresh (and then prune the other run's checkpoints)."""


# ---------------------------------------------------------------------------
# Fingerprints (``checkpoint.py:114-231``).
# ---------------------------------------------------------------------------

# Fields that may differ between the saving and the restoring run: where
# things live, how chatty or threaded the host is, and how long to train.
_FP_EXCLUDE = {"checkpoint_dir", "verbose", "num_workers", "datapath",
               "num_epochs"}

# ParallelConfig fields that describe LAYOUT — where values live and how the
# step is scheduled — not what the model computes.  ``data_parallel`` is not
# here: the global batch is batch_size * dp, so it is identity.
LAYOUT_FIELDS = frozenset({
    "parts", "split_size", "schedule", "num_spatial_parts", "spatial_size",
    "slice_method", "spatial_until", "quant_collectives", "stripe_bwd",
    "halo_d2", "fused_layers", "local_dp_lp", "balance",
    "times", "remat", "pallas_conv", "enable_gems", "enable_master_comm_opt",
})


def _normalize(obj: Any) -> Any:
    """JSON-able normal form shared by every fingerprint and by the
    manifest's ``layout_desc``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _normalize(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {
            str(k): _normalize(v)
            for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))
            if str(k) not in _FP_EXCLUDE
        }
    if isinstance(obj, (list, tuple)):
        return [_normalize(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        # hash randomization makes set iteration order process-dependent
        return sorted((_normalize(v) for v in obj), key=repr)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


def config_fingerprint(*parts: Any) -> str:
    """Stable 16-hex-char digest of config-like objects (dataclasses, dicts,
    tuples, scalars), without the volatile fields of ``_FP_EXCLUDE``."""
    blob = json.dumps([_normalize(p) for p in parts], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def split_config_fingerprint(
    cfg: Any,
    mesh_spec: Any = None,
    extra_identity: Optional[dict] = None,
    extra_layout: Optional[dict] = None,
) -> Tuple[str, str, dict]:
    """``(identity_fp, layout_fp, layout_desc)`` of ``cfg`` (a ParallelConfig
    or a dict): identity hashes the non-layout fields and
    ``extra_identity``; layout hashes :data:`LAYOUT_FIELDS`, the mesh spec
    and ``extra_layout``; ``layout_desc`` is the normalized layout dict."""
    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
    ident = {k: v for k, v in d.items()
             if k not in LAYOUT_FIELDS and k not in _FP_EXCLUDE}
    layout = {k: v for k, v in d.items() if k in LAYOUT_FIELDS}
    if mesh_spec is not None:
        layout["mesh"] = mesh_spec
    layout.update(extra_layout or {})
    layout_desc = _normalize(layout)
    return (
        config_fingerprint(ident, extra_identity or {}),
        config_fingerprint(layout_desc),
        layout_desc,
    )


def _check_fingerprints(manifest: dict, expected: Optional[str],
                        identity: Optional[str], layout: Optional[str],
                        where: str) -> bool:
    """Fingerprint policy for one manifest; returns ``elastic`` (the layout
    differs, the identity matches).  Raises :class:`CheckpointMismatch` on
    an identity mismatch (or, for single-fingerprint files, any).  An
    unknown side (None) is permissive."""
    m_ident = manifest.get("identity")
    m_layout = manifest.get("layout")
    if identity and m_ident:
        if m_ident != identity:
            raise CheckpointMismatch(
                f"{where}: model identity fingerprint {m_ident} != expected "
                f"{identity} (checkpoint from a different model/program)"
            )
        return bool(layout and m_layout and m_layout != layout)
    fp = manifest.get("fingerprint")
    if expected and fp and fp != expected:
        raise CheckpointMismatch(
            f"{where}: config/mesh fingerprint {fp} != expected "
            f"{expected} (checkpoint from a different program)"
        )
    return False


# ---------------------------------------------------------------------------
# Host bytes.  Leaves travel as CPU tensors; the manifest names dtypes as
# numpy (and ml_dtypes, for bfloat16) print them.
# ---------------------------------------------------------------------------

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    return _NAMES[dtype]


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError as e:
        raise CheckpointInvalid(f"unknown leaf dtype {name!r}") from e


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=_torch_dtype(name)).element_size()


def _host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU tensor that owns its bytes (a later step may write
    the device buffer it came from)."""
    return x.detach().to("cpu", copy=True).contiguous()


def _byte_view(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 numpy view of a contiguous CPU tensor's bytes."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _from_bytes(raw: bytes, name: str, shape) -> torch.Tensor:
    dt = _torch_dtype(name)
    if len(raw) == 0:
        return torch.empty(tuple(shape), dtype=dt)
    return torch.frombuffer(bytearray(raw), dtype=dt).reshape(tuple(shape))


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _crc(t: torch.Tensor) -> int:
    return binascii.crc32(_byte_view(t)) & 0xFFFFFFFF


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """The npz payload of a leaf: bfloat16 as numpy stores the JAX
    package's bfloat16 arrays (2-byte void), the rest as themselves."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(a: np.ndarray, name: Optional[str]) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # keeps 0-d arrays 0-d
    if name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# Leaves of a state.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Leaf:
    """One leaf of a state: shape, dtype name, whether this process holds
    it, its shards as ``[(global offset, gather)]`` (each ``gather()``
    returns one host block; a tensor is one shard) and ``put(host
    tensor)``, which writes the whole leaf into place."""

    shape: Tuple[int, ...]
    dtype: str
    held: bool
    shards: List[Tuple[Tuple[int, ...], Callable[[], torch.Tensor]]]
    put: Callable[[torch.Tensor], None]

    def full(self) -> torch.Tensor:
        ((_, gather),) = self.shards
        return gather()


def _zero_offset(shape) -> Tuple[int, ...]:
    return tuple(0 for _ in shape)


@torch.no_grad()
def _copy_into(t: torch.Tensor, src: torch.Tensor) -> None:
    t.copy_(src)


def _tensor_leaf(t: torch.Tensor) -> Leaf:
    shape = tuple(t.shape)
    return Leaf(shape, dtype_name(t.dtype), t.device.type != "meta",
                [(_zero_offset(shape), lambda: _host(t))],
                lambda src: _copy_into(t, src))


def _scalar_leaf(get: Callable[[], int], put: Callable[[int], None],
                 held: bool = True) -> Leaf:
    """An int32 scalar held as a Python int (a step count)."""
    return Leaf((), "int32", held,
                [((), lambda: torch.tensor(get(), dtype=torch.int32))],
                lambda src: put(int(src)))


def _zeros_leaf(shape, held: bool) -> Leaf:
    """An optimizer slot of a running statistic: the JAX optimizer keeps
    zeros there (the loss has no gradient for it); restore ignores it."""
    shape = tuple(shape)
    return Leaf(shape, "float32", held,
                [(_zero_offset(shape), lambda: torch.zeros(shape, dtype=torch.float32))],
                lambda src: None)


def _absent_leaf(shape) -> Leaf:
    """An optimizer slot that another rank's optimizer holds."""
    def put(src):
        raise AssertionError("put into a leaf this process does not hold")

    return Leaf(tuple(shape), "float32", False, [], put)


def _tree_tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_tensors(tree[k])]
    if isinstance(tree, list):
        return [t for c in tree for t in _tree_tensors(c)]
    return [tree]


def _tensor_dicts(tree):
    """The dicts of tensors (one a layer) in a params pytree."""
    if isinstance(tree, list):
        return [d for c in tree for d in _tensor_dicts(c)]
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return [tree]
    return [d for v in tree.values() for d in _tensor_dicts(v)]


def _train_state_leaves(state) -> List[Leaf]:
    from torch import nn

    from mpi4dl_tpu_torch.params import layout_tensors

    tree = layout_tensors(state.model)
    tensors = _tree_tensors(tree)
    params = state.params if state.params is not None else list(state.model.parameters())
    index = {id(p): i for i, p in enumerate(params)}
    # A layer's tensors are this process's to save when its optimizer
    # updates the layer: a GEMS rank's mirror copy of another stage is
    # refreshed from that stage's rank before every step, so it is stale
    # after the update and that rank writes the stage.
    stale = {id(t) for d in _tensor_dicts(tree)
             if not any(id(p) in index for p in d.values() if isinstance(p, nn.Parameter))
             and any(isinstance(p, nn.Parameter) for p in d.values())
             for t in d.values()}
    leaves = []
    for t in tensors:
        leaf = _tensor_leaf(t)
        leaf.held = leaf.held and id(t) not in stale
        leaves.append(leaf)
    opt = state.opt_state
    if len(opt) not in (0, 1, 3):
        raise TypeError(f"unknown optimizer state of {len(opt)} entries")
    for slot in opt[:2]:
        for t in tensors:
            i = index.get(id(t))
            if i is not None:
                leaves.append(_tensor_leaf(slot[i]))
            elif isinstance(t, nn.Parameter):
                leaves.append(_absent_leaf(t.shape))
            else:
                leaves.append(_zeros_leaf(t.shape, t.device.type != "meta"
                                          and id(t) not in stale))
    if len(opt) == 3:
        def put_count(n):
            state.opt_state = (*state.opt_state[:2], n)

        leaves.append(_scalar_leaf(lambda: state.opt_state[2], put_count))

    def put_step(n):
        state.step = n

    leaves.append(_scalar_leaf(lambda: state.step, put_step))
    return leaves


def state_leaves(state: Any) -> List[Leaf]:
    """The leaves of ``state`` in the JAX package's order (module
    docstring): a TrainState, a dict (sorted keys), a list or tuple, a
    tensor, or None (no leaves)."""
    from mpi4dl_tpu_torch.train import TrainState

    if isinstance(state, TrainState):
        return _train_state_leaves(state)
    if state is None:
        return []
    if isinstance(state, dict):
        return [l for k in sorted(state) for l in state_leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [l for c in state for l in state_leaves(c)]
    if isinstance(state, torch.Tensor):
        return [_tensor_leaf(state)]
    raise TypeError(f"no checkpoint leaves for {type(state).__name__}")


def state_to_arrays(state: Any, step_id: int) -> Dict[str, torch.Tensor]:
    """Every leaf of ``state`` as a whole host tensor (the v1 payload)."""
    arrays = {f"leaf_{i}": l.full() for i, l in enumerate(state_leaves(state))}
    arrays[STEP_KEY] = torch.tensor(step_id, dtype=torch.int64)
    return arrays


# ---------------------------------------------------------------------------
# Process group helpers (all no-ops without a group).
# ---------------------------------------------------------------------------


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_gather(obj, group) -> list:
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _broadcast(obj, group):
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def leaf_owners(leaves: List[Leaf], group=None) -> List[int]:
    """The rank of ``group`` that writes each leaf: the lowest holding it."""
    held = [i for i, l in enumerate(leaves) if l.held]
    owner = [-1] * len(leaves)
    for r, ids in reversed(list(enumerate(_all_gather(held, group)))):
        for i in ids:
            owner[i] = r
    lost = [i for i, o in enumerate(owner) if o < 0]
    if lost:
        raise ValueError(f"no rank holds leaves {lost[:8]} (of {len(lost)})")
    return owner


# ---------------------------------------------------------------------------
# v1 (npz) save path.
# ---------------------------------------------------------------------------


def _manifest_for(arrays: Dict[str, torch.Tensor], fingerprint: Optional[str]) -> dict:
    leaves = {}
    for k, a in arrays.items():
        if k.startswith("leaf_"):
            leaves[k] = {"crc32": _crc(a), "shape": list(a.shape),
                         "dtype": dtype_name(a.dtype)}
    return {
        "schema": MANIFEST_SCHEMA,
        "step_id": int(arrays[STEP_KEY]),
        "fingerprint": fingerprint,
        "leaves": leaves,
    }


def _fsync_dir(path: str) -> None:
    dfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def write_arrays(path: str, arrays: Dict[str, torch.Tensor],
                 fingerprint: Optional[str] = None) -> None:
    """Write host leaves and their manifest to ``path`` (v1 npz): temporary
    file, flush, fsync, atomic rename, directory fsync."""
    payload = {k: _to_numpy(v) for k, v in arrays.items()}
    manifest = _manifest_for(arrays, fingerprint)
    payload[MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest, sort_keys=True).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)  # make the rename itself durable
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_state(path: str, state: Any, step_id: int,
               fingerprint: Optional[str] = None) -> None:
    """Write ``state`` to ``path`` atomically (v1 npz)."""
    write_arrays(path, state_to_arrays(state, step_id), fingerprint)


# ---------------------------------------------------------------------------
# v2 (sharded) save path.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SaveStats:
    """What one checkpoint save cost (summed over the ranks that wrote;
    the times are the slowest rank's)."""

    path: str = ""
    step_id: int = 0
    format: str = "sharded"
    bytes: int = 0
    shards: int = 0
    leaves: int = 0
    gather_ms: float = 0.0
    write_ms: float = 0.0
    # Watermark of gathered-but-unwritten host bytes: one shard.
    peak_pending_bytes: int = 0


def _write_shard_file(path: str, view: np.ndarray) -> None:
    """Write and fsync one shard payload (idempotent, so ``retry_io`` may
    call it again)."""
    with open(path, "wb") as f:
        f.write(memoryview(view))
        f.flush()
        os.fsync(f.fileno())


class ShardedSaveTxn:
    """One sharded checkpoint write: shard files land fsync'd in a hidden
    temporary directory; ``commit`` writes the manifest, fsyncs and
    publishes with one atomic directory rename (and a parent fsync).

    ``tmpdir`` joins the temporary directory of a transaction another rank
    opened: this rank adds its shards, and the opener commits."""

    def __init__(self, path: str, step_id: int,
                 fingerprint: Optional[str] = None,
                 identity: Optional[str] = None,
                 layout: Optional[str] = None,
                 layout_desc: Optional[dict] = None,
                 tmpdir: Optional[str] = None) -> None:
        self.path = os.path.abspath(path)
        self.step_id = int(step_id)
        self.stats = SaveStats(path=self.path, step_id=self.step_id)
        self._meta = {"fingerprint": fingerprint, "identity": identity,
                      "layout": layout, "layout_desc": layout_desc}
        self._leaves: Dict[int, dict] = {}
        d = os.path.dirname(self.path)
        if tmpdir is None:
            os.makedirs(d, exist_ok=True)
            tmpdir = tempfile.mkdtemp(dir=d, prefix=f".tmp_ckpt_{step_id}_")
        self._tmp = tmpdir
        self._done = False

    def add_leaf(self, leaf_id: int, meta: dict) -> None:
        self._leaves[leaf_id] = {"shape": list(meta["shape"]),
                                 "dtype": meta["dtype"], "shards": []}

    def add_shard(self, leaf_id: int, offset: Tuple[int, ...],
                  arr: torch.Tensor) -> int:
        """Write one host shard durably; returns the bytes written."""
        t0 = time.perf_counter()
        entry = self._leaves[leaf_id]
        fname = f"leaf{leaf_id:05d}_s{len(entry['shards']):03d}.bin"
        view = _byte_view(arr)
        retry_io(lambda: _write_shard_file(os.path.join(self._tmp, fname), view),
                 retries=_IO_RETRIES, backoff=_IO_BACKOFF)
        entry["shards"].append({
            "file": fname,
            "offset": [int(o) for o in offset],
            "shape": list(arr.shape),
            "nbytes": int(view.nbytes),
            "crc32": binascii.crc32(view) & 0xFFFFFFFF,
        })
        self.stats.shards += 1
        self.stats.bytes += int(view.nbytes)
        self.stats.write_ms += (time.perf_counter() - t0) * 1e3
        return int(view.nbytes)

    def commit(self) -> SaveStats:
        t0 = time.perf_counter()
        manifest = {
            "schema": MANIFEST_SCHEMA_V2,
            "step_id": self.step_id,
            "leaves": [self._leaves[i] for i in sorted(self._leaves)],
            **self._meta,
        }
        mpath = os.path.join(self._tmp, SHARD_MANIFEST)
        with open(mpath, "w", encoding="utf-8") as f:
            json.dump(manifest, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(self._tmp)
        aside = None
        if os.path.isdir(self.path):
            # Re-save of a step id: move the old checkpoint ASIDE first, so
            # its data is never deleted before the new one is published.
            aside = tempfile.mkdtemp(dir=os.path.dirname(self.path),
                                     prefix=f".old_ckpt_{self.step_id}_")
            os.rmdir(aside)  # the unique NAME; the rename creates the dir
            os.replace(self.path, aside)
        os.replace(self._tmp, self.path)
        _fsync_dir(os.path.dirname(self.path))
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        self._done = True
        self.stats.leaves = len(self._leaves)
        self.stats.write_ms += (time.perf_counter() - t0) * 1e3
        return self.stats

    def abort(self) -> None:
        if not self._done:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._done = True


def _stream_leaves_into(txn: ShardedSaveTxn, leaves: List[Leaf], ids) -> None:
    """Gather → write → free, one shard at a time (peak host bytes = the
    largest shard)."""
    for i in ids:
        leaf = leaves[i]
        txn.add_leaf(i, {"shape": list(leaf.shape), "dtype": leaf.dtype})
        for offset, gather in leaf.shards:
            t0 = time.perf_counter()
            arr = gather()
            txn.stats.gather_ms += (time.perf_counter() - t0) * 1e3
            txn.stats.peak_pending_bytes = max(
                txn.stats.peak_pending_bytes, arr.numel() * arr.element_size())
            txn.add_shard(i, offset, arr)
            del arr


# ---------------------------------------------------------------------------
# Restore path.
# ---------------------------------------------------------------------------


def checkpoint_format(path: str) -> str:
    """``"sharded"`` (v2 directory) or ``"npz"`` (v1 file)."""
    return "sharded" if os.path.isdir(path) else "npz"


def _read_text(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def read_sharded_manifest(path: str) -> dict:
    mpath = os.path.join(path, SHARD_MANIFEST)
    try:
        # Transient OSErrors retry; a manifest that reads but does not parse
        # is torn, and a missing one is deterministic: neither retries.
        raw = retry_io(lambda: _read_text(mpath),
                       retries=_IO_RETRIES, backoff=_IO_BACKOFF,
                       no_retry=(FileNotFoundError,))
        return json.loads(raw)
    except OSError as e:
        raise CheckpointInvalid(f"{path}: no readable manifest ({e!r})") from e
    except ValueError as e:
        raise CheckpointInvalid(f"{path}: bad manifest ({e!r})") from e


def _peek_npz_manifest(path: str):
    """Open a v1 npz and read ONLY its manifest member."""
    try:
        z = np.load(path)
    except Exception as e:  # noqa: BLE001 — zipfile/np errors on torn files vary
        raise CheckpointInvalid(f"{path}: unreadable ({e!r})") from e
    if MANIFEST_KEY not in z.files:
        return None, z
    try:
        manifest = json.loads(bytes(z[MANIFEST_KEY]).decode())
    except Exception as e:  # noqa: BLE001 — zlib/json/unicode all mean torn
        z.close()
        raise CheckpointInvalid(f"{path}: bad manifest ({e!r})") from e
    return manifest, z


def _manifest_leaf_shapes(manifest: dict) -> Optional[List[Tuple[int, ...]]]:
    leaves = manifest.get("leaves")
    if leaves is None:
        return None
    if isinstance(leaves, dict):  # v1: {"leaf_3": {...}}
        try:
            items = sorted(leaves.items(), key=lambda kv: int(kv[0][5:]))
        except ValueError:
            return None
        return [tuple(v.get("shape", ())) for _, v in items]
    return [tuple(l.get("shape", ())) for l in leaves]  # v2: ordered list


def cheap_validate(path: str, template: Any = None,
                   fingerprint: Optional[str] = None,
                   identity: Optional[str] = None,
                   layout: Optional[str] = None) -> Tuple[Optional[dict], bool]:
    """Manifest-first validation, reading no array bytes: the container
    opens, the fingerprints (identity hard, layout soft), the leaf count
    and shapes against ``template``, and every shard file present at its
    manifest size.  Returns ``(manifest, elastic)``."""
    if checkpoint_format(path) == "sharded":
        manifest = read_sharded_manifest(path)
        if manifest.get("schema") != MANIFEST_SCHEMA_V2:
            raise CheckpointInvalid(
                f"{path}: unknown sharded schema {manifest.get('schema')!r}")
        for leaf_id, leaf in enumerate(manifest.get("leaves", [])):
            total = 0
            for sh in leaf.get("shards", []):
                try:
                    size = os.stat(os.path.join(path, sh["file"])).st_size
                except OSError as e:
                    raise CheckpointInvalid(
                        f"{path}: shard file {sh['file']} missing "
                        f"(leaf {leaf_id}): {e!r}") from e
                if size != sh["nbytes"]:
                    raise CheckpointInvalid(
                        f"{path}: shard file {sh['file']} is {size} bytes, "
                        f"manifest says {sh['nbytes']} (torn write?)")
                total += sh["nbytes"]
            expect = _prod(leaf["shape"]) * _itemsize(leaf["dtype"])
            if total != expect:
                raise CheckpointInvalid(
                    f"{path}: leaf {leaf_id} shards cover {total} bytes of "
                    f"{expect} (incomplete shard set)")
    else:
        manifest, z = _peek_npz_manifest(path)
        z.close()
        if manifest is None:
            return None, False  # no manifest: nothing to validate cheaply
    elastic = _check_fingerprints(manifest, fingerprint, identity, layout, path)
    if template is not None:
        shapes = _manifest_leaf_shapes(manifest)
        if shapes is not None:
            tmpl_shapes = [l.shape for l in state_leaves(template)]
            if len(shapes) != len(tmpl_shapes):
                raise CheckpointMismatch(
                    f"{path}: checkpoint has {len(shapes)} leaves, state "
                    f"needs {len(tmpl_shapes)}")
            for i, (a, b) in enumerate(zip(shapes, tmpl_shapes)):
                if tuple(a) != tuple(b):
                    raise CheckpointMismatch(
                        f"{path}: leaf {i}: checkpoint shape {tuple(a)} != "
                        f"state {b}"
                        + (" (layout change is not leaf-shape-preserving — "
                           "this geometry cannot restore elastically)"
                           if elastic else ""))
    return manifest, elastic


def _read_shard_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def load_sharded_arrays(path: str, manifest: Optional[dict] = None,
                        leaf_ids=None) -> Tuple[Dict[str, torch.Tensor], int]:
    """Full load of a v2 checkpoint (of the leaves ``leaf_ids``, default
    all): each leaf reassembled from its shards at their global offsets,
    each shard CRC32-verified.  Returns ``({"leaf_<i>": host tensor},
    step_id)``."""
    manifest = manifest if manifest is not None else read_sharded_manifest(path)
    want = None if leaf_ids is None else set(leaf_ids)
    arrays: Dict[str, torch.Tensor] = {}
    for leaf_id, leaf in enumerate(manifest.get("leaves", [])):
        if want is not None and leaf_id not in want:
            continue
        shape = tuple(leaf["shape"])
        out = torch.empty(shape, dtype=_torch_dtype(leaf["dtype"]))
        for sh in leaf["shards"]:
            try:
                raw = retry_io(
                    lambda f=os.path.join(path, sh["file"]): _read_shard_bytes(f),
                    retries=_IO_RETRIES, backoff=_IO_BACKOFF,
                    no_retry=(FileNotFoundError,))
            except OSError as e:  # a vanished or unreadable shard: torn
                raise CheckpointInvalid(
                    f"{path}: shard file {sh['file']} unreadable ({e!r})") from e
            if (binascii.crc32(raw) & 0xFFFFFFFF) != sh["crc32"]:
                raise CheckpointInvalid(
                    f"{path}: CRC32 mismatch on {sh['file']} (leaf {leaf_id})")
            if len(raw) != sh["nbytes"]:
                raise CheckpointInvalid(
                    f"{path}: {sh['file']} is {len(raw)} bytes, manifest "
                    f"says {sh['nbytes']}")
            block = _from_bytes(raw, leaf["dtype"], sh["shape"])
            if not shape:
                out = block.reshape(())
            else:
                out[tuple(slice(o, o + n) for o, n in zip(sh["offset"], sh["shape"]))] = block
        arrays[f"leaf_{leaf_id}"] = out
    return arrays, int(manifest.get("step_id", 0))


def load_arrays(path: str, expected_fingerprint: Optional[str] = None
                ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Load and VALIDATE one checkpoint (either format); returns
    ``(arrays, step_id)``.  Raises :class:`CheckpointInvalid` on a torn or
    corrupt file, a CRC mismatch, or a fingerprint mismatch."""
    if checkpoint_format(path) == "sharded":
        manifest = read_sharded_manifest(path)
        _check_fingerprints(manifest, expected_fingerprint, None, None, path)
        return load_sharded_arrays(path, manifest)
    manifest, z = _peek_npz_manifest(path)
    try:
        raw = {k: z[k] for k in z.files if k != MANIFEST_KEY}
    except Exception as e:  # noqa: BLE001 — torn member payloads surface here
        raise CheckpointInvalid(f"{path}: unreadable ({e!r})") from e
    finally:
        z.close()
    info = (manifest or {}).get("leaves", {})
    if manifest is not None:
        _check_fingerprints(manifest, expected_fingerprint, None, None, path)
        for k, meta in info.items():
            a = raw.get(k)
            if a is None:
                raise CheckpointInvalid(f"{path}: manifest leaf {k} missing")
            if binascii.crc32(np.ascontiguousarray(a)) & 0xFFFFFFFF != meta.get("crc32"):
                raise CheckpointInvalid(f"{path}: CRC32 mismatch on {k}")
    step = raw.pop(STEP_KEY, None)
    arrays = {k: _from_numpy(a, info.get(k, {}).get("dtype")) for k, a in raw.items()}
    step_id = int(step) if step is not None else int((manifest or {}).get("step_id", 0))
    return arrays, step_id


def arrays_to_state(arrays: Dict[str, torch.Tensor], template: Any) -> Any:
    """Copy loaded leaves into ``template`` in place (each cast to the
    template's dtype, on its device) and return it.  Only the leaves this
    process holds are written; the shapes are checked before any copy."""
    leaves = state_leaves(template)
    extra = [k for k in arrays if k.startswith("leaf_") and int(k[5:]) >= len(leaves)]
    missing = [i for i, l in enumerate(leaves) if l.held and f"leaf_{i}" not in arrays]
    if extra or missing:
        n = sum(1 for k in arrays if k.startswith("leaf_"))
        raise CheckpointMismatch(f"checkpoint has {n} leaves, state needs {len(leaves)}")
    for i, leaf in enumerate(leaves):
        if not leaf.held:
            continue
        arr = arrays[f"leaf_{i}"]
        if tuple(arr.shape) != leaf.shape:
            raise CheckpointMismatch(
                f"leaf {i}: checkpoint shape {tuple(arr.shape)} != state {leaf.shape}")
    for i, leaf in enumerate(leaves):
        if leaf.held:
            leaf.put(arrays[f"leaf_{i}"])
    return template


def restore_state(path: str, template: Any,
                  expected_fingerprint: Optional[str] = None) -> Any:
    """Load leaves from ``path`` into ``template`` after validation."""
    arrays, _ = load_arrays(path, expected_fingerprint)
    return arrays_to_state(arrays, template)


@dataclasses.dataclass
class RestoreInfo:
    """What ``restore_latest`` did: the path, the step, the format, whether
    the restore was elastic and the layout the checkpoint was saved
    under."""

    path: str
    step_id: int
    format: str
    elastic: bool = False
    saved_layout: Optional[dict] = None


# ---------------------------------------------------------------------------
# Manager.
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Numbered checkpoints in a directory — ``ckpt_<step>/`` sharded
    directories (format "sharded", the default) or ``ckpt_<step>.npz``
    (format "npz") — keeping the newest ``keep``.  ``restore_latest``
    reads both formats.

    ``fingerprint`` is the combined digest; ``identity``/``layout`` the
    split pair of :func:`split_config_fingerprint`.  ``group``: the process
    group whose ranks save and restore one state together (module
    docstring); every rank of it makes the same calls.  Without one this
    process holds the whole state."""

    def __init__(self, directory: str, keep: int = 3,
                 fingerprint: Optional[str] = None, *,
                 identity: Optional[str] = None,
                 layout: Optional[str] = None,
                 layout_desc: Optional[dict] = None,
                 format: str = "sharded",
                 group=None) -> None:
        if format not in ("sharded", "npz"):
            raise ValueError(f"unknown checkpoint format {format!r}")
        if format == "npz" and group is not None and dist.get_world_size(group) > 1:
            raise ValueError("the npz format is written by one process; use sharded")
        self.directory = directory
        self.keep = keep
        self.fingerprint = fingerprint
        self.identity = identity
        self.layout = layout
        self.layout_desc = layout_desc
        self.format = format
        self.group = group
        self.rank = _rank(group)
        self.last_save_stats: Optional[SaveStats] = None
        self.last_restore: Optional[RestoreInfo] = None
        if self.rank == 0:
            os.makedirs(directory, exist_ok=True)
            # A hard crash can strand hidden work dirs (.tmp_ckpt_* from a
            # save killed mid-write, .old_ckpt_* from a re-save killed
            # mid-swap); construction is a safe point to reclaim them.
            for fn in os.listdir(directory):
                if fn.startswith((".tmp_ckpt_", ".old_ckpt_")):
                    shutil.rmtree(os.path.join(directory, fn), ignore_errors=True)
        if group is not None:
            dist.barrier(group=group)

    def _all(self):
        out = []
        for fn in os.listdir(self.directory):
            m = _CKPT_RE.match(fn) or _CKPT_DIR_RE.match(fn)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, fn)))
        return sorted(out)

    def latest_path(self) -> Optional[str]:
        all_ = self._all()
        return all_[-1][1] if all_ else None

    def path_for(self, step_id: int) -> str:
        name = f"ckpt_{step_id}" + (".npz" if self.format == "npz" else "")
        return os.path.join(self.directory, name)

    def _prune(self) -> None:
        for _sid, p in self._all()[: -self.keep]:
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.unlink(p)

    def begin_save(self, step_id: int) -> ShardedSaveTxn:
        return ShardedSaveTxn(self.path_for(step_id), step_id, self.fingerprint,
                              self.identity, self.layout, self.layout_desc)

    def finish_save(self, txn: ShardedSaveTxn) -> SaveStats:
        try:
            stats = txn.commit()
        except BaseException:
            # Never leave the hidden temporary directory behind.
            txn.abort()
            raise
        self.last_save_stats = stats
        self._prune()
        return stats

    def save(self, state: Any, step_id: int) -> str:
        """Save ``state`` in this manager's format; sharded, each rank
        writes the leaves it owns (:func:`leaf_owners`) one shard at a time
        and rank 0 publishes.  Returns the checkpoint's path."""
        if self.format == "npz":
            path = self.path_for(step_id)
            arrays = state_to_arrays(state, step_id)
            write_arrays(path, arrays, self.fingerprint)
            self.last_save_stats = SaveStats(
                path=path, step_id=step_id, format="npz",
                bytes=sum(a.numel() * a.element_size() for a in arrays.values()),
                leaves=len(arrays) - 1)
            self._prune()
            return path
        leaves = state_leaves(state)
        owners = leaf_owners(leaves, self.group)
        txn = self.begin_save(step_id) if self.rank == 0 else None
        tmp = _broadcast(txn._tmp if txn is not None else None, self.group)
        mine = txn or ShardedSaveTxn(self.path_for(step_id), step_id, tmpdir=tmp)
        error = None
        try:
            _stream_leaves_into(mine, leaves, [i for i, o in enumerate(owners)
                                               if o == self.rank])
        except Exception as e:  # noqa: BLE001 — reported to every rank below
            error = f"rank {self.rank}: {e!r}"
        parts = _all_gather((error, mine._leaves, dataclasses.asdict(mine.stats)),
                            self.group)
        errors = [e for e, _, _ in parts if e is not None]
        if txn is not None:
            if errors:
                txn.abort()
            else:
                for _, entries, st in parts[1:]:
                    txn._leaves.update(entries)
                    txn.stats.shards += st["shards"]
                    txn.stats.bytes += st["bytes"]
                    for k in ("gather_ms", "write_ms", "peak_pending_bytes"):
                        setattr(txn.stats, k, max(getattr(txn.stats, k), st[k]))
                try:
                    self.finish_save(txn)
                except Exception as e:  # noqa: BLE001 — reported to every rank below
                    errors.append(f"rank 0 commit: {e!r}")
        errors = _broadcast(errors, self.group)
        if errors:
            raise OSError(f"checkpoint save at step {step_id} failed: {errors}")
        return self.path_for(step_id)

    def _load_local(self, path: str, template: Any, leaves: List[Leaf]):
        """Validate ``path`` and load the leaves this process holds:
        ``("ok", (arrays, step_id, manifest, elastic))``, ``("mismatch",
        error)`` or ``("invalid", error)``."""
        try:
            manifest, elastic = cheap_validate(path, template, self.fingerprint,
                                               self.identity, self.layout)
            if checkpoint_format(path) == "sharded":
                held = [i for i, l in enumerate(leaves) if l.held]
                arrays, step_id = load_sharded_arrays(path, manifest, held)
            else:
                arrays, step_id = load_arrays(path, self.fingerprint)
            return "ok", (arrays, step_id, manifest, elastic)
        except CheckpointMismatch as e:
            logger.warning("checkpoint from a different program %s: %s", path, e)
            return "mismatch", e
        except Exception as e:  # noqa: BLE001 — torn/corrupt: walk past
            logger.warning("skipping invalid checkpoint %s: %s", path, e)
            return "invalid", e

    def restore_latest(self, template: Any, require: bool = False) -> Tuple[Any, int]:
        """Restore the newest VALID checkpoint into ``template``; returns
        ``(state, step_id)``.

        The walk is manifest-first: a candidate is cheaply validated before
        its leaves are read; a torn or corrupt one is skipped with a
        warning.  With a group, a candidate is restored only when every
        rank loaded its leaves.  A checkpoint whose layout fingerprint
        differs but whose identity matches restores elastically
        (``last_restore.elastic``).  With no valid checkpoint: ``(template,
        0)``, unless ``require`` (then :class:`CheckpointInvalid`); when a
        candidate was from a different program (:class:`CheckpointMismatch`)
        that mismatch is raised instead."""
        leaves = state_leaves(template)
        candidates = _broadcast([p for _, p in reversed(self._all())], self.group)
        mismatch: Optional[CheckpointMismatch] = None
        for path in candidates:
            status, out = self._load_local(path, template, leaves)
            statuses = _all_gather(status, self.group)
            if all(s == "ok" for s in statuses):
                arrays, step_id, manifest, elastic = out
                try:
                    arrays_to_state(arrays, template)
                except CheckpointMismatch as e:  # same on every rank: held leaves agree
                    mismatch = mismatch or e
                    continue
                self.last_restore = RestoreInfo(
                    path=path, step_id=step_id, format=checkpoint_format(path),
                    elastic=elastic, saved_layout=(manifest or {}).get("layout_desc"))
                if elastic:
                    logger.warning(
                        "ELASTIC restore from %s (step %d): checkpoint layout "
                        "differs from this run's", path, step_id)
                logger.info("restored checkpoint %s (step %d)", path, step_id)
                return template, step_id
            if status == "mismatch":
                mismatch = mismatch or out
        if mismatch is not None:
            raise mismatch
        if require:
            raise CheckpointInvalid(
                f"no valid checkpoint in {self.directory} "
                f"({len(candidates)} file(s) present, all invalid)")
        return template, 0
