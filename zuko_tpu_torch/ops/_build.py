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
# a whole-flow kernel's tier: wide, workspace, its floats, rows a launch,
# descriptor buffer, its bytes
_TIER = [_I, _P, _LL, _LL, _P, _LL]
# (input, one or two outputs, weights, widths, passes, softclip bounds, n_lin,
# n_ar, F, C, K, K2, univariate, bound, log-slope, slope, Gauss-Legendre rule,
# box, lo, hi, log(hi - lo), rows, the tier, stream)
_NSF_FLOW = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P, _I, _F, _F, _F, _LL,
             *_TIER, _P]
# then the tiled tier's staged weights and tile rows
_NSF_TILED = [*_NSF_FLOW, _P, _I]
_NSF_TWO_OUTPUTS = ([_P, _P, _P, *_NSF_TILED], _I)
# (packed, kinds, Ks, offs, shifts, raws, row strides, feature strides,
# stages, F, rows, the tier, stream)
_GF_FLOW = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, *_TIER, _P]
# then the tiled sampler's tile rows (0: not tiled)
_GF_TILED = [*_GF_FLOW, _I]
# (packed, kinds, passes, bounds, offsets, stages, MADE widths, MADE linears,
# network widths, network linears, F, C, S, mode, rows, then the tier: wide,
# workspace, its floats, rows a launch, descriptor buffer, its bytes; the
# narrow tier's tile rows; stream)
_NAF_FLOW = [_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _LL, *_TIER, _I, _P]
# (input, probe, per-row first bias, one or two outputs, weights, widths,
# linears, frequencies and their count, atol, rtol, trace scale, max_steps,
# trace mode, rows, the tier, stream, then the cluster tier's padded
# linears and tile rows)
_CNF_FLOW = [_P, _P, _I, _I, _P, _F, _F, _F, _I, _I, _LL, *_TIER, _P, _P, _I]
# (samples, their cotangent, log-q cotangent, probe, per-row first bias, u1,
# a1, per-tile sums, per-row first bias's cotangent, weights, the padded
# linears, widths, linears, frequencies and their count, atol, rtol,
# max_steps, trace mode, rows, tile, the tier, stream)
_CNF_ADJOINT = [_P] * 11 + [_P, _I, _I, _P, _F, _F, _I, _I, _LL, _I, *_TIER, _P]
# argument types of every C entry point, by library; each library also has
# ``<library>_error_string`` (declared by ``load_library``)
_SIGNATURES = {
    "nsf_fused": {
        "nsf_density_f32": ([_P, _P, *_NSF_TILED], _I),
        "nsf_apply_f32": _NSF_TWO_OUTPUTS,
        "nsf_sample_f32": _NSF_TWO_OUTPUTS,
        "nsf_sample_raw_f32": _NSF_TWO_OUTPUTS,
        "nsf_max_shared_bytes": ([_I], _I),
    },
    "gf_fused": {
        "gf_density_f32": ([_P, _P, *_GF_FLOW], _I),
        "gf_sample_f32": ([_P, _P, _P, *_GF_TILED], _I),
    },
    "naf_fused": {
        "naf_density_f32": ([_P, _P, *_NAF_FLOW], _I),
        "naf_sample_f32": ([_P, _P, _P, *_NAF_FLOW], _I),
    },
    "cnf_fused": {
        "cnf_density_f32": ([_P, _P, _P, _P, *_CNF_FLOW], _I),
        "cnf_sample_f32": ([_P, _P, _P, _P, _P, *_CNF_FLOW], _I),
        "cnf_adjoint_f32": (_CNF_ADJOINT, _I),
    },
    "masked_linear": {
        "masked_linear_f32": ([_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P], _I),
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
