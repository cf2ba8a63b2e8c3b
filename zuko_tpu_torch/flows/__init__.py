r"""Flow recipes ported so far: MAF, NSF, GF, NAF and UNAF (counterpart of
``zuko_tpu/flows/__init__.py``)."""

from ..lazy import Flow
from .autoregressive import MAF, MaskedAutoregressiveTransform
from .gaussianization import GF, ElementWiseTransform
from .neural import MNN, NAF, UMNN, UNAF
from .spline import NSF

__all__ = [
    "ElementWiseTransform", "Flow", "GF", "MAF", "MNN", "MaskedAutoregressiveTransform", "NAF",
    "NSF", "UMNN", "UNAF",
]
