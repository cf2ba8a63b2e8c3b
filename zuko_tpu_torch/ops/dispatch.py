r"""Automatic fused-kernel dispatch for the flows.

Counterpart of ``zuko_tpu/ops/dispatch.py``: when a :class:`~zuko_tpu_torch.lazy.Flow`
is called, its structure is inspected and — if the whole-flow kernels can
represent it — the returned distribution routes ``log_prob``, ``sample`` and
``sample_and_log_prob`` through :mod:`zuko_tpu_torch.ops.nsf_fused`, and
``rsample`` / ``rsample_and_log_prob`` through :mod:`zuko_tpu_torch.ops.ift`.
An inverted flow, ``Flow(flow.transform.inv, flow.base)``, swaps the roles.
A flow the extractor rejects with ``FusedStructureError`` keeps the unfused
transform path.

Dispatch policy (``ZUKO_TPU_TORCH_FUSED_DISPATCH``):

* ``"auto"`` (default): fused when the flow's parameters are on CUDA;
* ``"1"``: always fused (the CPU tests use it to run the fused plain math);
* ``"0"``: never fused.
"""

from __future__ import annotations

import os

import torch

from ..distributions import NormalizingFlow
from ..lazy import LazyInverse
from .ift import fused_nsf_inverse_and_ladj, fused_nsf_rsample
from .nsf_fused import (
    FusedStructureError,
    _flatten_flow,
    fused_nsf_apply,
    fused_nsf_log_prob,
    fused_nsf_sample,
)

__all__ = [
    "FusedAutoregressiveFlow",
    "FusedInvertedAutoregressiveFlow",
    "fused_dispatch_enabled",
    "maybe_fused_flow",
]


def fused_dispatch_enabled(module: torch.nn.Module) -> bool:
    """Whether ``Flow.forward`` should attempt fused dispatch for ``module``."""
    env = os.environ.get("ZUKO_TPU_TORCH_FUSED_DISPATCH", "auto")
    if env == "0":
        return False
    if env == "1":
        return True
    p = next(module.parameters(), None)
    return p is not None and p.is_cuda


class FusedAutoregressiveFlow(NormalizingFlow):
    r"""A :class:`NormalizingFlow` whose density and sampling run through the
    fused whole-flow kernels (NSF/MAF structure). ``log_prob`` is
    differentiable; ``sample`` and ``sample_and_log_prob`` are not;
    ``rsample`` and ``rsample_and_log_prob`` run the same solve with
    implicit-function-theorem gradients (:mod:`zuko_tpu_torch.ops.ift`).
    ``flat`` is the flow module's extracted ``(params, layout, cfg)``, taken
    once per ``flow(c)``."""

    def __init__(self, transform, base, flat, c):
        super().__init__(transform, base)
        self._flat = flat
        self._c = c

    def log_prob(self, x):
        return fused_nsf_log_prob(self._flat, x, self._c)

    def sample(self, sample_shape=(), generator=None):
        return fused_nsf_sample(self._flat, sample_shape, self._c, generator)

    def sample_and_log_prob(self, sample_shape=(), generator=None):
        return fused_nsf_sample(
            self._flat, sample_shape, self._c, generator, want_log_prob=True
        )

    def rsample(self, sample_shape=(), generator=None):
        return fused_nsf_rsample(self._flat, sample_shape, self._c, generator)

    def rsample_and_log_prob(self, sample_shape=(), generator=None):
        return fused_nsf_rsample(
            self._flat, sample_shape, self._c, generator, want_log_prob=True
        )


class FusedInvertedAutoregressiveFlow(NormalizingFlow):
    r"""An inverted flow (``Flow(flow.transform.inv, flow.base)``, the
    reverse-KL recipe) whose roles swap onto the fused kernels: sampling is
    the forward apply (:func:`~zuko_tpu_torch.ops.nsf_fused.fused_nsf_apply`,
    no solve at all, differentiable), and ``log_prob`` is the fused solve
    with raw-mode IFT gradients
    (:func:`~zuko_tpu_torch.ops.ift.fused_nsf_inverse_and_ladj`). ``flat``
    is extracted from the un-inverted structure. ``sample`` and
    ``sample_and_log_prob`` are the inherited gradient-free forms of
    ``rsample`` and ``rsample_and_log_prob``."""

    def __init__(self, transform, base, flat, c):
        super().__init__(transform, base)
        self._flat = flat
        self._c = c

    def log_prob(self, x):
        u, ladj = fused_nsf_inverse_and_ladj(self._flat, x, self._c)
        return self.base.log_prob(u) - ladj

    def rsample(self, sample_shape=(), generator=None):
        z = self.base.rsample(sample_shape, generator)
        y, _ = fused_nsf_apply(self._flat, z, self._c)
        return y

    def rsample_and_log_prob(self, sample_shape=(), generator=None):
        z = self.base.rsample(sample_shape, generator)
        y, ladj = fused_nsf_apply(self._flat, z, self._c)
        return y, self.base.log_prob(z) - ladj


class _UninvertedShim:
    """What the extractor sees for an inverted flow: the inner (forward)
    lazy transform with the flow's own base."""

    def __init__(self, transform, base):
        self.transform = transform
        self.base = base


def maybe_fused_flow(module, transform, base, c):
    """Return a fused :class:`NormalizingFlow` for ``module`` if its structure
    matches the fused kernels, else ``None`` (the caller keeps the unfused
    distribution)."""
    if isinstance(module.transform, LazyInverse):
        try:
            flat = _flatten_flow(_UninvertedShim(module.transform.transform, module.base))
        except FusedStructureError:
            return None  # an inverted flow of another structure stays unfused
        return FusedInvertedAutoregressiveFlow(transform, base, flat, c)
    try:
        flat = _flatten_flow(module)
    except FusedStructureError:
        return None
    return FusedAutoregressiveFlow(transform, base, flat, c)
