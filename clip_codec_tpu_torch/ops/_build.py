"""Build and bind the package's CUDA kernels (nvcc + ctypes) and its host
C++ library (the system C++ compiler + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/kernels/`` at the root of the checkout, under a file name
that carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import:
a machine without ``nvcc`` or a card imports every module, and ``nvcc`` is
needed only when a kernel is first launched on a card. ``build_host``
does the same for a ``csrc/<name>.cpp`` of host code (the store codec),
into ``build/native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "native"
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-Wall")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str, extra: Tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<name>.cu`` is built: named by a hash of source, the
    shared headers (``csrc/*.cuh``) and flags (``extra``: more nvcc flags,
    such as a development build's ``-D`` defines)."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS + extra).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str, extra: Tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with the nvcc flags ``extra`` too) unless
    its library is already built.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<lib>.log``."""
    out = library_path(name, extra)
    if not out.exists():
        _compile(out, lambda tmp: [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, str(CSRC / f"{name}.cu")])
    return out


def _compile(out: Path, command) -> None:
    """Run ``command(tmp)``, which writes a library to ``tmp``, and rename it
    to ``out`` (concurrent builders never load a half-written library); the
    compiler's output is kept as ``<out>.log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)


def build_host(name: str, libs: Tuple[str, ...] = ()) -> Path:
    """Compile the host C++ file ``csrc/<name>.cpp`` into a shared library
    with the system C++ compiler (``$CXX``, else ``c++``), linked against
    ``libs`` (linker arguments such as ``-l:libzstd.so.1``), unless it is
    already built under ``build/native/``, named by a hash of the source,
    flags and libraries."""
    src = CSRC / f"{name}.cpp"
    cxx = os.environ.get("CXX") or "c++"
    flags = (cxx, *HOST_FLAGS, *libs)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = HOST_BUILD_DIR / f"lib{name}_{digest}.so"
    if not out.exists():
        _compile(out, lambda tmp: [cxx, *HOST_FLAGS, "-o", tmp, str(src), *libs])
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu``'s library (once per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
