r"""Automatic fused-kernel dispatch for the flows.

Counterpart of ``zuko_tpu/ops/dispatch.py``: when a :class:`~zuko_tpu_torch.lazy.Flow`
is called, its structure is inspected and — if the whole-flow kernels can
represent it — the returned distribution routes ``log_prob``, ``sample`` and
``sample_and_log_prob`` through :mod:`zuko_tpu_torch.ops.nsf_fused` (NSF, MAF,
NCSF, and SOSPF and BPF as :class:`FusedDensityFlow`),
:mod:`zuko_tpu_torch.ops.gf_fused` (GF), :mod:`zuko_tpu_torch.ops.cnf_fused`
(CNF) or :mod:`zuko_tpu_torch.ops.naf_fused` (NAF, UNAF), and ``rsample`` /
``rsample_and_log_prob`` through :mod:`zuko_tpu_torch.ops.ift` (a CNF's
through the continuous adjoint of :mod:`zuko_tpu_torch.ops.cnf_fused`). An inverted
autoregressive flow, ``Flow(flow.transform.inv, flow.base)``, swaps the
roles. A flow every extractor rejects with ``FusedStructureError`` keeps the
unfused transform path.

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
from .cnf_fused import _flatten_cnf, fused_cnf_log_prob, fused_cnf_rsample, fused_cnf_sample
from .gf_fused import _flatten_gf, fused_gf_log_prob, fused_gf_sample
from .ift import (
    fused_gf_rsample,
    fused_naf_rsample,
    fused_nsf_inverse_and_ladj,
    fused_nsf_rsample,
)
from .naf_fused import _flatten_naf, fused_naf_log_prob, fused_naf_sample
from .nsf_fused import (
    FusedStructureError,
    _flatten_flow,
    fused_nsf_apply,
    fused_nsf_log_prob,
    fused_nsf_sample,
)

__all__ = [
    "FusedAutoregressiveFlow",
    "FusedContinuousFlow",
    "FusedDensityFlow",
    "FusedGaussianizationFlow",
    "FusedInvertedAutoregressiveFlow",
    "FusedNeuralSamplingFlow",
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


class FusedDensityFlow(FusedAutoregressiveFlow):
    r"""The polynomial families' (SOSPF, BPF) :class:`FusedAutoregressiveFlow`
    (counterpart of ``FusedDensityFlow`` :126): the density through the
    whole-flow kernel, sampling through its iterative inverse (a bisection
    on the exact forward, then Newton steps whose derivative the forward
    gives for free), and ``rsample`` through the same solve with
    implicit-function-theorem gradients, exact at the solved point to the
    solver's tolerance."""


class FusedGaussianizationFlow(NormalizingFlow):
    r"""A :class:`NormalizingFlow` whose density and sampling run through the
    fused GF kernels (:mod:`zuko_tpu_torch.ops.gf_fused`): analytic
    gaussianization log-Jacobians, rotation products and per-feature
    bisection inverses. ``rsample`` / ``rsample_and_log_prob`` run the same
    solve with implicit-function-theorem gradients
    (:mod:`zuko_tpu_torch.ops.ift`: diagonal solves and rotation products,
    no iteration). ``flat`` is ``_flatten_gf(flow, c, transform)``, taken once
    per ``flow(c)`` from the tensors ``transform`` already holds (the
    hyper-networks' outputs and the rotations)."""

    def __init__(self, transform, base, flat):
        super().__init__(transform, base)
        self._flat = flat

    def log_prob(self, x):
        return fused_gf_log_prob(self._flat, x)

    def sample(self, sample_shape=(), generator=None):
        return fused_gf_sample(self._flat, sample_shape, generator)

    def sample_and_log_prob(self, sample_shape=(), generator=None):
        return fused_gf_sample(self._flat, sample_shape, generator, want_log_prob=True)

    def rsample(self, sample_shape=(), generator=None):
        return fused_gf_rsample(self._flat, sample_shape, generator)

    def rsample_and_log_prob(self, sample_shape=(), generator=None):
        return fused_gf_rsample(self._flat, sample_shape, generator, want_log_prob=True)


class FusedContinuousFlow(NormalizingFlow):
    r"""A :class:`NormalizingFlow` whose density and sampling run through the
    fused CNF kernels (:mod:`zuko_tpu_torch.ops.cnf_fused`): the whole
    adaptive Dormand-Prince integration per tile of rows, with the
    log-Jacobian for ``log_prob`` and ``sample_and_log_prob``, without it for
    ``sample``. ``log_prob`` is differentiable (autograd over the global-step
    integration). ``rsample`` and ``rsample_and_log_prob`` run the same
    sampling forward with continuous-adjoint gradients
    (:func:`~zuko_tpu_torch.ops.cnf_fused.fused_cnf_rsample`: one adjoint
    integration per tile from the samples back to the base draws, the
    ``cnf_adjoint`` kernel on the card), as ``zuko_tpu`` does by default
    (``zuko_tpu/ops/dispatch.py:226-243``). ``flat`` is
    ``_flatten_cnf(flow, transform, c)``, taken once per ``flow(c)``."""

    def __init__(self, transform, base, flat, c):
        super().__init__(transform, base)
        self._flat = flat
        self._c = c

    def log_prob(self, x):
        return fused_cnf_log_prob(self._flat, x, self._c)

    def sample(self, sample_shape=(), generator=None):
        return fused_cnf_sample(self._flat, sample_shape, self._c, generator)

    def sample_and_log_prob(self, sample_shape=(), generator=None):
        return fused_cnf_sample(self._flat, sample_shape, self._c, generator, want_log_prob=True)

    def rsample(self, sample_shape=(), generator=None):
        return fused_cnf_rsample(self._flat, sample_shape, self._c, generator)

    def rsample_and_log_prob(self, sample_shape=(), generator=None):
        return fused_cnf_rsample(self._flat, sample_shape, self._c, generator, want_log_prob=True)


class FusedNeuralSamplingFlow(NormalizingFlow):
    r"""A :class:`NormalizingFlow` whose density and sampling run through the
    fused NAF kernels (:mod:`zuko_tpu_torch.ops.naf_fused`), for a NAF or a
    UNAF: the density with the univariates' analytic log-Jacobians, sampling
    by the bisection-and-Newton solve of every sweep. ``rsample`` /
    ``rsample_and_log_prob`` run the same solve with implicit-function-theorem
    gradients (:mod:`zuko_tpu_torch.ops.ift`). ``flat`` is the flow module's
    ``_flatten_naf``, taken once per ``flow(c)``."""

    def __init__(self, transform, base, flat, c):
        super().__init__(transform, base)
        self._flat = flat
        self._c = c

    def log_prob(self, x):
        return fused_naf_log_prob(self._flat, x, self._c)

    def sample(self, sample_shape=(), generator=None):
        return fused_naf_sample(self._flat, sample_shape, self._c, generator)

    def sample_and_log_prob(self, sample_shape=(), generator=None):
        return fused_naf_sample(self._flat, sample_shape, self._c, generator, want_log_prob=True)

    def rsample(self, sample_shape=(), generator=None):
        return fused_naf_rsample(self._flat, sample_shape, self._c, generator)

    def rsample_and_log_prob(self, sample_shape=(), generator=None):
        return fused_naf_rsample(self._flat, sample_shape, self._c, generator, want_log_prob=True)


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
        pass
    else:
        if flat[2]["univ"] in ("sosp", "bernstein"):
            return FusedDensityFlow(transform, base, flat, c)
        return FusedAutoregressiveFlow(transform, base, flat, c)
    try:
        return FusedGaussianizationFlow(transform, base, _flatten_gf(module, c, transform))
    except FusedStructureError:
        pass
    try:
        return FusedContinuousFlow(transform, base, _flatten_cnf(module, transform, c), c)
    except FusedStructureError:
        pass
    try:
        return FusedNeuralSamplingFlow(transform, base, _flatten_naf(module), c)
    except FusedStructureError:
        return None
