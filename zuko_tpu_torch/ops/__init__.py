r"""Hand-written CUDA kernels (CUDA C++ under ``csrc/``), their plain PyTorch
versions and the automatic dispatch (counterpart of ``zuko_tpu/ops``): the
whole-flow NSF/MAF kernels and their implicit-function-theorem backward, and
the per-op kernels of the unfused path (``masked_linear``, ``rqs``). Every
wrapper launches its kernel for a CUDA tensor and takes its plain version
for a CPU tensor."""

from . import masked_linear, rqs
from ._common import LAUNCHES, reset_launches
from .ift import (
    fused_nsf_inverse_and_ladj,
    fused_nsf_rsample,
    fused_nsf_rsample_and_log_prob,
)
from .nsf_fused import (
    FusedStructureError,
    extract_nsf_params,
    fused_nsf_apply,
    fused_nsf_log_prob,
    fused_nsf_sample,
    nsf_apply,
    nsf_density,
    nsf_sample,
)
from .rqs import rqs_forward, rqs_inverse

__all__ = [
    "FusedStructureError",
    "LAUNCHES",
    "extract_nsf_params",
    "fused_nsf_apply",
    "fused_nsf_inverse_and_ladj",
    "fused_nsf_log_prob",
    "fused_nsf_rsample",
    "fused_nsf_rsample_and_log_prob",
    "fused_nsf_sample",
    "nsf_apply",
    "nsf_density",
    "nsf_sample",
    "reset_launches",
    "rqs_forward",
    "rqs_inverse",
]
