"""Build and load the port's CUDA kernels.

At first use ``library()`` compiles every ``csrc/*.cu`` of the package with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, links the objects into one shared library with a plain C
interface in ``build/`` at the repository root, and loads it with
``ctypes``. The library's file name carries a hash of the sources, the
headers (``csrc/*.cuh``) and the flags, so an edited file never loads a
stale build. Nothing here runs at import: the package imports on machines
with no ``nvcc`` and no CUDA.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I = ctypes.c_void_p, ctypes.c_int
_MAPS = ([_P] * 9 + [_I] * 12 + [_P], ctypes.c_int)
_PEAKS = ([_P] * 10 + [_I] * 12 + [_P], ctypes.c_int)
_MAC = ([_P] * 6 + [_I] * 3 + [ctypes.c_longlong, _I, _I, _P], ctypes.c_int)
# C entry points: name → (argtypes, restype). Every pointer and the stream
# are c_void_p; without argtypes ctypes would pass them as 32-bit ints. The
# kernels have one entry per dtype mode: spectra f32 or bf16, and for the
# maps kernel f32 or bf16 maps (_bf16maps); fp32 spectra also at the
# 6xTF32 (_x6) and one-pass (_x1) synthesis tiers, bf16 spectra at BF16IO
# (_io).
_SIGNATURES = {
    "fftconv_block_conv_f32": _MAPS,
    "fftconv_block_conv_f32_bf16maps": _MAPS,
    "fftconv_block_conv_bf16": _MAPS,
    "fftconv_block_conv_bf16_bf16maps": _MAPS,
    "fftconv_block_conv_f32_x6": _MAPS,
    "fftconv_block_conv_f32_bf16maps_x6": _MAPS,
    "fftconv_block_conv_f32_x1": _MAPS,
    "fftconv_block_conv_f32_bf16maps_x1": _MAPS,
    "fftconv_block_conv_bf16_io": _MAPS,
    "fftconv_block_conv_bf16_bf16maps_io": _MAPS,
    "fftconv_block_conv_f32_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "fftconv_block_conv_f32_rows": ([_I, _I, _I], ctypes.c_int),
    "fftconv_block_conv_f32_blocks": ([_I, _I, _I], ctypes.c_int),
    "fftconv_block_conv_peaks_f32": _PEAKS,
    "fftconv_block_conv_peaks_bf16": _PEAKS,
    "fftconv_block_conv_peaks_f32_x6": _PEAKS,
    "fftconv_block_conv_peaks_f32_x1": _PEAKS,
    "fftconv_block_conv_peaks_bf16_io": _PEAKS,
    "fftconv_spectral_mac_f32": _MAC,
    "fftconv_spectral_mac_bf16": _MAC,
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
    """Every file the library is built from: the ``.cu`` translation units
    and the ``.cuh`` headers they include."""
    return sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")])


def _library_path(sources: list[pathlib.Path]) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libfftconv_torch_{h.hexdigest()[:16]}.so"


def _compile(sources: list[pathlib.Path], target: pathlib.Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    units = [s for s in sources if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in units]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(units, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {s.name}\n{out}" for s, out in zip(units, logs))
        failed = [s.name for s, p in zip(units, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = os.path.join(tmp, target.name)
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, target)  # atomic: a concurrent build never sees half a file
    return log + link.stdout


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
