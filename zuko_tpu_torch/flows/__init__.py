r"""Flow recipes ported so far: MAF and NSF (counterpart of
``zuko_tpu/flows/__init__.py``)."""

from ..lazy import Flow
from .autoregressive import MAF, MaskedAutoregressiveTransform
from .spline import NSF

__all__ = ["Flow", "MAF", "MaskedAutoregressiveTransform", "NSF"]
