r"""Flow recipes ported so far: MAF, NSF and GF (counterpart of
``zuko_tpu/flows/__init__.py``)."""

from ..lazy import Flow
from .autoregressive import MAF, MaskedAutoregressiveTransform
from .gaussianization import GF, ElementWiseTransform
from .spline import NSF

__all__ = ["ElementWiseTransform", "Flow", "GF", "MAF", "MaskedAutoregressiveTransform", "NSF"]
