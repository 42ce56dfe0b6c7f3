"""Build and load the port's CUDA kernels.

At first use ``library()`` compiles the package's ``csrc/*.cu`` with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, links the objects into a shared library with a plain C interface
in ``build/`` at the repository root, and loads it with ``ctypes``. The
radix-2 bodies' sources (``block_conv_r4.cu``, ``_r5.cu``, ``_r5x.cu``)
make a second library, ``library(radix=True)``, built at the first radix
call, and the Karatsuba H stage's (``block_conv_k.cu``,
``block_conv_k_tiers.cu``, ``block_conv_peaks_k.cu``) a third,
``library(forms=True)``, and the radix
bodies' Karatsuba entries (``block_conv_r4_k.cu``, ``_r5_k.cu``,
``_r5x_k.cu``) a fourth, ``library(radix=True, forms=True)``: no default
route launches them, so the other paths do not wait for their builds. A
library's file name carries a hash of its sources, the
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
_MAPS_RADIX = ([_P] * 12 + [_I] * 12 + [_P], ctypes.c_int)
_PEAKS_RADIX = ([_P] * 13 + [_I] * 12 + [_P], ctypes.c_int)
_MAC = ([_P] * 6 + [_I] * 3 + [ctypes.c_longlong, _I, _I, _P], ctypes.c_int)
_QUERY = ([_I, _I, _I], ctypes.c_int)
_SMEM_QUERY = ([_I, _I, _I], ctypes.c_longlong)
# C entry points: name → (argtypes, restype). Every pointer and the stream
# are c_void_p; without argtypes ctypes would pass them as 32-bit ints. The
# kernels have one entry per dtype mode: spectra f32 or bf16, and for the
# maps kernel f32 or bf16 maps (_bf16maps); fp32 spectra also at the
# 6xTF32 (_x6) and one-pass (_x1) synthesis tiers, bf16 spectra at BF16IO
# (_io). The radix library has each of those for the radix-2 bodies (_r4,
# _r5, _r5x: three more pointers, csrc/block_conv.cuh RadixOps); the forms
# library the Karatsuba H stage's (_k: maps and peaks) and its
# configuration queries; the radix forms library the radix bodies' entries
# in the Karatsuba form (_r4_k, _r5_k, _r5x_k). The v2 body's maps entries
# (_v2, _v2_k: v3's kernels, csrc/block_conv.cu) sit beside v3's entries of
# the same form, in the main and the forms library, with v3's arguments; its
# configuration queries are the forms library's.
_RADIX_UNITS = ("block_conv_r4.cu", "block_conv_r5.cu", "block_conv_r5x.cu")
_FORM_UNITS = ("block_conv_k.cu", "block_conv_k_tiers.cu", "block_conv_peaks_k.cu")
_RADIX_FORM_UNITS = ("block_conv_r4_k.cu", "block_conv_r5_k.cu", "block_conv_r5x_k.cu")
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
    "fftconv_block_conv_f32_smem_bytes": _SMEM_QUERY,
    "fftconv_block_conv_f32_rows": _QUERY,
    "fftconv_block_conv_f32_blocks": _QUERY,
    "fftconv_block_conv_f32_kernels": _QUERY,
    "fftconv_block_conv_f32_cluster": _QUERY,
    "fftconv_block_conv_f32_pair_bins": _QUERY,
    "fftconv_block_conv_peaks_f32": _PEAKS,
    "fftconv_block_conv_peaks_bf16": _PEAKS,
    "fftconv_block_conv_peaks_f32_x6": _PEAKS,
    "fftconv_block_conv_peaks_f32_x1": _PEAKS,
    "fftconv_block_conv_peaks_bf16_io": _PEAKS,
    "fftconv_spectral_mac_f32": _MAC,
    "fftconv_spectral_mac_bf16": _MAC,
}
_RADIX_SIGNATURES = {
    f"{name}{body}": _PEAKS_RADIX if sig is _PEAKS else _MAPS_RADIX
    for name, sig in _SIGNATURES.items() if sig in (_MAPS, _PEAKS)
    for body in ("_r4", "_r5", "_r5x")
}

_FORM_SIGNATURES = {
    **{f"{name}{form}": sig for name, sig in _SIGNATURES.items() if sig is _MAPS
       for form in ("_k", "_v2_k")},
    **{f"{name}_k": sig for name, sig in _SIGNATURES.items() if sig is _PEAKS},
    "fftconv_block_conv_k_smem_bytes": _SMEM_QUERY,
    "fftconv_block_conv_k_rows": _QUERY,
    "fftconv_block_conv_k_cluster": _QUERY,
    "fftconv_block_conv_k_pair_bins": _QUERY,
    "fftconv_block_conv_v2_smem_bytes": ([_I] * 4, ctypes.c_longlong),
    "fftconv_block_conv_v2_rows": ([_I] * 4, ctypes.c_int),
    "fftconv_block_conv_v2_blocks": ([_I] * 4, ctypes.c_int),
}
_RADIX_FORM_SIGNATURES = {f"{name}_k": sig for name, sig in _RADIX_SIGNATURES.items()}
_V2_SIGNATURES = {f"{name}_v2": sig for name, sig in _SIGNATURES.items() if sig is _MAPS}
# library kind → (its translation units: None for every unit the others do
# not take, its signatures, its file name's tag)
_KINDS = {
    "main": (None, {**_SIGNATURES, **_V2_SIGNATURES}, ""),
    "radix": (_RADIX_UNITS, _RADIX_SIGNATURES, "radix_"),
    "forms": (_FORM_UNITS, _FORM_SIGNATURES, "forms_"),
    "radix_forms": (_RADIX_FORM_UNITS, _RADIX_FORM_SIGNATURES, "radix_forms_"),
}

_locks = {kind: threading.Lock() for kind in _KINDS}
_libs: dict[str, ctypes.CDLL] = {}
_build_logs = {kind: "" for kind in _KINDS}


def _kind(radix: bool, forms: bool) -> str:
    return {(False, False): "main", (True, False): "radix", (False, True): "forms",
            (True, True): "radix_forms"}[(bool(radix), bool(forms))]


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


def _sources(radix: bool = False, forms: bool = False) -> list[pathlib.Path]:
    """Every file a library is built from: its ``.cu`` translation units
    (the radix bodies' for ``radix``, the other forms' for ``forms``, the
    radix bodies' Karatsuba entries for both, the rest else) and the
    ``.cuh`` headers they include."""
    units = _KINDS[_kind(radix, forms)][0]
    others = _RADIX_UNITS + _FORM_UNITS + _RADIX_FORM_UNITS
    cu = [s for s in _CSRC.glob("*.cu") if (s.name in units if units else s.name not in others)]
    return sorted([*cu, *_CSRC.glob("*.cuh")])


def _library_path(sources: list[pathlib.Path]) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    names = {s.name for s in sources}
    tag = next((t for units, _, t in _KINDS.values() if units and names & set(units)), "")
    return BUILD_DIR / f"libfftconv_torch_{tag}{h.hexdigest()[:16]}.so"


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


def library(radix: bool = False, forms: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (``radix``: the radix bodies'; ``forms``:
    the Karatsuba and v2 entries'; both: the radix bodies' Karatsuba
    entries), built on first call."""
    kind = _kind(radix, forms)
    with _locks[kind]:
        lib = _libs.get(kind)
        if lib is None:
            sources = _sources(radix, forms)
            path = _library_path(sources)
            if not path.exists():
                _build_logs[kind] = _compile(sources, path)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _KINDS[kind][1].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[kind] = lib
        return lib


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    this process's builds of the libraries, or '' where they were already
    built."""
    return "".join(_build_logs.values())
