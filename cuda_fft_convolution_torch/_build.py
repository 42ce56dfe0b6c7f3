"""Build and load the port's CUDA kernels.

At first use ``library()`` compiles every ``csrc/*.cu`` of the package with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, writes it to ``build/`` at the repository root, and loads it with
``ctypes``. The library's file name carries a hash of the sources and flags,
so an edited source never loads a stale build. Nothing here runs at import:
the package imports on machines with no ``nvcc`` and no CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name → (argtypes, restype). Every pointer and the stream
# are c_void_p; without argtypes ctypes would pass them as 32-bit ints.
_SIGNATURES = {
    "fftconv_block_conv_f32": ([_P] * 9 + [_I] * 11 + [_P], ctypes.c_int),
    "fftconv_block_conv_f32_smem_bytes": ([_I], ctypes.c_longlong),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of cuda_fft_convolution_torch cannot be built"
    )


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu"))


def _library_path(sources: list[pathlib.Path]) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libfftconv_torch_{h.hexdigest()[:16]}.so"


def _compile(sources: list[pathlib.Path], target: pathlib.Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _build_log
    with _lock:
        if _lib is None:
            sources = _sources()
            path = _library_path(sources)
            if not path.exists():
                _build_log = _compile(sources, path)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    this process's build, or '' when the library was already built."""
    return _build_log
