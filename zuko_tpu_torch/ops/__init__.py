r"""Fused whole-flow kernels (CUDA C++ under ``csrc/``), their plain PyTorch
versions and the automatic dispatch (counterpart of ``zuko_tpu/ops``)."""

from .nsf_fused import (
    LAUNCHES,
    FusedStructureError,
    extract_nsf_params,
    fused_nsf_log_prob,
    fused_nsf_sample,
    nsf_density,
    nsf_sample,
    reset_launches,
)

__all__ = [
    "FusedStructureError",
    "LAUNCHES",
    "extract_nsf_params",
    "fused_nsf_log_prob",
    "fused_nsf_sample",
    "nsf_density",
    "nsf_sample",
    "reset_launches",
]
