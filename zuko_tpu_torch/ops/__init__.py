r"""Hand-written CUDA kernels (CUDA C++ under ``csrc/``), their plain PyTorch
versions and the automatic dispatch (counterpart of ``zuko_tpu/ops``): the
whole-flow NSF/MAF, GF, NAF/UNAF and CNF kernels (each in a narrow and a wide
tier, chosen from the flow's shapes) and their implicit-function-theorem
backward, and the per-op kernels of the unfused path (``masked_linear``,
``rqs``). Every wrapper launches its kernel for a CUDA tensor and takes its
plain version for a CPU tensor."""

from . import masked_linear, rqs
from ._common import LAUNCHES, reset_launches
from .cnf_fused import (
    cnf_adjoint,
    cnf_density,
    cnf_sample,
    extract_cnf_params,
    fused_cnf_log_prob,
    fused_cnf_rsample,
    fused_cnf_sample,
)
from .gf_fused import (
    extract_gf_params,
    fused_gf_log_prob,
    fused_gf_sample,
    gf_density,
    gf_sample,
)
from .ift import (
    fused_gf_rsample,
    fused_gf_rsample_and_log_prob,
    fused_naf_rsample,
    fused_naf_rsample_and_log_prob,
    fused_nsf_inverse_and_ladj,
    fused_nsf_rsample,
    fused_nsf_rsample_and_log_prob,
)
from .naf_fused import (
    extract_naf_params,
    fused_naf_log_prob,
    fused_naf_sample,
    naf_density,
    naf_sample,
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
    "cnf_adjoint",
    "cnf_density",
    "cnf_sample",
    "extract_cnf_params",
    "extract_gf_params",
    "extract_naf_params",
    "extract_nsf_params",
    "fused_cnf_log_prob",
    "fused_cnf_rsample",
    "fused_cnf_sample",
    "fused_gf_log_prob",
    "fused_gf_rsample",
    "fused_gf_rsample_and_log_prob",
    "fused_gf_sample",
    "fused_naf_log_prob",
    "fused_naf_rsample",
    "fused_naf_rsample_and_log_prob",
    "fused_naf_sample",
    "fused_nsf_apply",
    "fused_nsf_inverse_and_ladj",
    "fused_nsf_log_prob",
    "fused_nsf_rsample",
    "fused_nsf_rsample_and_log_prob",
    "fused_nsf_sample",
    "gf_density",
    "gf_sample",
    "naf_density",
    "naf_sample",
    "nsf_apply",
    "nsf_density",
    "nsf_sample",
    "reset_launches",
    "rqs_forward",
    "rqs_inverse",
]
