"""Per-collective-class quantization policy (counterpart of
``mpi4dl_tpu/quant/policy.py``).

A policy maps each of the four hot collective classes (``junction``,
``respatial``, ``grad``, ``handoff``) to a payload mode (``int8`` /
``fp8`` / ``int4`` / ``off``) plus the shared block size of the per-block
scales.  The spec grammar (config ``--quant``, hatch
``MPI4DL_QUANT_COLLECTIVES``)::

    off                          # everything exact (the default)
    int8                         # every class int8 (also fp8 / int4)
    junction=int4,grad=int8      # per-class; unnamed classes stay off
    int8,block=128               # mode plus block-size override

An all-off policy is ``None`` at the call sites: the engines built from it
are today's, bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple

CLASSES: Tuple[str, ...] = ("junction", "respatial", "grad", "handoff")
_MODES = ("off", "int8", "fp8", "int4")

DEFAULT_BLOCK = 256

# The obs.scope names of the collectives each class owns.  loss_reduce and
# the in-cell BatchNorm sums are not hot: scalar payloads, kept exact.
HOT_SCOPE_PATTERNS = {
    "junction": re.compile(r"junction|stage_lineup"),
    "respatial": re.compile(r"respatial"),
    "grad": re.compile(r"grad_reduce|stats_reduce"),
    "handoff": re.compile(r"stage_handoff|cot_handoff"),
}


def scope_quant_class(scope: str) -> Optional[str]:
    """The quantization class owning an ``obs.scope`` path, or None."""
    for cls, pat in HOT_SCOPE_PATTERNS.items():
        if pat.search(scope or ""):
            return cls
    return None


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """One resolved per-class payload policy; ``off`` for a class keeps its
    collectives exact."""

    junction: str = "off"
    respatial: str = "off"
    grad: str = "off"
    handoff: str = "off"
    block: int = DEFAULT_BLOCK

    def mode(self, cls: str) -> Optional[str]:
        """Payload mode of a class, or None when the class is exact."""
        if cls not in CLASSES:
            raise ValueError(f"unknown quant class {cls!r}; have {CLASSES}")
        m = getattr(self, cls)
        return None if m == "off" else m

    @property
    def active(self) -> bool:
        return any(self.mode(c) for c in CLASSES)

    def spec(self) -> str:
        """Canonical spec string (round-trips through :meth:`parse`)."""
        if not self.active:
            return "off"
        parts = [f"{c}={getattr(self, c)}" for c in CLASSES if self.mode(c)]
        if self.block != DEFAULT_BLOCK:
            parts.append(f"block={self.block}")
        return ",".join(parts)

    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["QuantPolicy"]:
        """Parse a spec string; None for off or empty.  Raises ValueError on
        an unknown class or mode or a bad block.  Bare modes set every
        class first, then ``class=mode`` pairs override, whatever their
        order."""
        spec = (spec or "").strip()
        if spec in ("", "off", "0", "none"):
            return None
        items = [s.strip() for s in spec.split(",") if s.strip()]
        fields = {c: "off" for c in CLASSES}
        block = DEFAULT_BLOCK
        for item in items:
            if "=" in item:
                continue
            if item not in _MODES:
                raise ValueError(f"unknown quant mode {item!r}; have {_MODES} "
                                 "(or class=mode pairs)")
            fields = {c: item for c in CLASSES}
        for item in items:
            if "=" not in item:
                continue
            key, _, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if key == "block":
                block = int(val)
                if block <= 0 or block % 2:
                    raise ValueError(f"quant block must be positive and even "
                                     f"(int4 packs payload pairs): {block}")
                continue
            if key not in CLASSES:
                raise ValueError(f"unknown quant class {key!r}; have {CLASSES}")
            if val not in _MODES:
                raise ValueError(f"unknown quant mode {val!r}; have {_MODES}")
            fields[key] = val
        p = cls(block=block, **fields)
        return p if p.active else None

    @classmethod
    def resolve(cls, config_spec: Optional[str]) -> Optional["QuantPolicy"]:
        """The config's spec, unless ``MPI4DL_QUANT_COLLECTIVES`` is set: the
        hatch wins, ``off`` included."""
        hatch = os.environ.get("MPI4DL_QUANT_COLLECTIVES")
        return cls.parse(hatch if hatch is not None else config_spec)


def class_mode(quant: Optional[QuantPolicy], cls: str) -> Tuple[Optional[str], int]:
    """``(mode, block)`` of a class under ``quant``; ``(None, 0)`` when the
    class is exact or the policy is off."""
    if quant is None:
        return None, 0
    return quant.mode(cls), quant.block
