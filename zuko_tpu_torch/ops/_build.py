r"""Build and load the CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface, for ``sm_90a`` (Hopper), at first use, into
``build/`` at the root of the checkout; all sources compile in parallel
(``csrc/*.cuh`` are headers they share). The libraries are loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from pathlib import Path

__all__ = ["BUILD_DIR", "build_all", "check_launch", "load_library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LIBS = {}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# (input, two outputs, weights, widths, passes, 6 ints, 2 floats, rows, stream)
_NSF_TWO_OUTPUTS = ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _LL, _P], _I)
# argument types of every C entry point, by library; each library also has
# ``<library>_error_string`` (declared by ``load_library``)
_SIGNATURES = {
    "nsf_fused": {
        "nsf_density_f32": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _LL, _P], _I),
        "nsf_apply_f32": _NSF_TWO_OUTPUTS,
        "nsf_sample_f32": _NSF_TWO_OUTPUTS,
        "nsf_sample_raw_f32": _NSF_TWO_OUTPUTS,
        "nsf_max_shared_bytes": ([_I], _I),
    },
    "masked_linear": {
        "masked_linear_f32": ([_P, _P, _P, _P, _P, _LL, _I, _I, _P], _I),
    },
    "rqs": {
        "rqs_f32": ([_P, _P, _P, _P, _P, _P, _I, _LL, _I, _P], _I),
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
    headers = max((h.stat().st_mtime for h in _CSRC.glob("*.cuh")), default=0.0)
    for src in sorted(_CSRC.glob("*.cu")):
        out = _target(src.stem)
        newest = max(src.stat().st_mtime, headers)
        if force or not out.exists() or out.stat().st_mtime < newest:
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


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed,
    with ``argtypes``/``restype`` declared for every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        signatures = {f"{name}_error_string": ([_I], ctypes.c_char_p), **_SIGNATURES[name]}
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def check_launch(name: str, lib: ctypes.CDLL, library: str, rc: int) -> None:
    """Raise if the C entry point of kernel ``name`` returned a CUDA error."""
    if rc != 0:
        message = getattr(lib, f"{library}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel failed: {message}")
