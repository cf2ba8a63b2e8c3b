r"""Flow recipes ported so far: MAF, NSF, NCSF, SOSPF, BPF, GF, NAF, UNAF and
CNF (counterpart of ``zuko_tpu/flows/__init__.py``)."""

from ..lazy import Flow
from .autoregressive import MAF, MaskedAutoregressiveTransform
from .continuous import CNF, FFJTransform
from .gaussianization import GF, ElementWiseTransform
from .neural import MNN, NAF, UMNN, UNAF
from .polynomial import BPF, SOSPF
from .spline import NCSF, NSF

__all__ = [
    "BPF", "CNF", "ElementWiseTransform", "FFJTransform", "Flow", "GF", "MAF", "MNN",
    "MaskedAutoregressiveTransform", "NAF", "NCSF", "NSF", "SOSPF", "UMNN", "UNAF",
]
