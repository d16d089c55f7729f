"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source ``csrc/<name>.cu`` exposes a plain C interface and compiles on
its own into ``build/kernels/lib<name>-<hash>.so`` at the repository root
(git-ignored), where ``<hash>`` covers the source, the shared headers
``csrc/*.cuh``, the flags and any preprocessor defines, so an edited source
or header is rebuilt and an unchanged one is loaded as it is.  Nothing
is built or loaded at import: the first launch does it, or
:func:`build_kernels` (which starts one ``nvcc`` per source, all at once).
Beside each library the build keeps ptxas's register, shared-memory and
spill report (``-Xptxas -v``) as ``lib<name>-<hash>.ptxas.txt``
(:func:`ptxas_report_path`), which the kernel certifier
(``analysis/pallascheck``) reads without rebuilding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("halo_conv", "block_flash")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use"
        )
    return path


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def ptxas_report_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """ptxas's report of the build of :func:`library_path`."""
    lib = library_path(name, defines)
    return lib.with_name(lib.name[: -len(".so")] + ".ptxas.txt")


def build_kernels(names: Optional[Iterable[str]] = None,
                  verbose: bool = False, defines: Tuple[str, ...] = ()) -> float:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source started together; return the wall seconds.  Raises
    with the compiler's output when a build fails.  ``verbose`` prints
    ptxas's register / shared-memory / spill report; ``defines`` are
    passed to nvcc as ``-D`` (a measurement build)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names or SOURCES:
        out = library_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        report = ptxas_report_path(name, defines)
        part = report.with_name(f"{report.name}.{os.getpid()}.tmp")
        part.write_text(log)
        os.replace(part, report)
        if verbose:
            # The caller asked for ptxas's report on stdout, where
            # chip_smoke.py's readers find it.
            print(f"[build] {name}.cu:\n{log.strip()}", flush=True)  # analysis: ok(print-call)
        os.replace(tmp, out)
    return time.perf_counter() - t0


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed."""
    with _LOCK:
        lib = _LIBS.get((name, defines))
        if lib is None:
            path = library_path(name, defines)
            if not path.exists():
                build_kernels([name], defines=defines)
            lib = _LIBS[(name, defines)] = ctypes.CDLL(str(path))
        return lib
