r"""Build and load the CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface, for ``sm_90a`` (Hopper), at first use, into
``build/`` at the root of the checkout; all sources compile in parallel. The
libraries are loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from pathlib import Path

__all__ = ["BUILD_DIR", "build_all", "load_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LIBS = {}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argument types of every C entry point, by library
_SIGNATURES = {
    "nsf_fused": {
        "nsf_density_f32": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _LL, _P], _I),
        "nsf_sample_f32": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _LL, _P], _I),
        "nsf_max_shared_bytes": ([_I], _I),
        "nsf_error_string": ([_I], ctypes.c_char_p),
    },
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA machine")
    return nvcc


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_all(force: bool = False) -> dict:
    """Compile every source whose library is missing or older than it, all
    in parallel; return ``{name: ptxas report}`` for the ones built. Raises
    with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(_CSRC.glob("*.cu")):
        out = _target(src.stem)
        if force or not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(src)]
            jobs[src.stem] = (tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load_library(name: str = "nsf_fused") -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed,
    with ``argtypes``/``restype`` declared for every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib
