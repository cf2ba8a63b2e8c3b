r"""Neural autoregressive flows.

Counterpart of ``zuko_tpu/flows/neural.py``: the monotonic neural network
:class:`MNN` :53 (a stacked :class:`~zuko_tpu_torch.nn.MonotonicMLP`
modulated by a per-feature signal), the transform it builds
(``_MonotonicNetTransform`` :37), the unconstrained monotonic network
:class:`UMNN` :86 (a stacked ELU :class:`~zuko_tpu_torch.nn.MLP` integrand)
and its transform (``_UMNNTransform`` :69), the interleaved construction
``_interleaved_flow`` :105 (a ``SoftclipTransform(bound=11)`` between the
autoregressive layers, the standard ``DiagNormal`` base as buffers) and the
:class:`NAF` :143 and :class:`UNAF` :184 recipes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..distributions import DiagNormal
from ..lazy import Flow, UnconditionalDistribution, UnconditionalTransform
from ..nn import MLP, MonotonicMLP
from ..transforms import (
    AdditiveTransform,
    ComposedTransform,
    MonotonicTransform,
    SoftclipTransform,
    UnconstrainedMonotonicTransform,
)
from ..utils import broadcast, gauss_legendre, resolve_device
from .autoregressive import MaskedAutoregressiveTransform

__all__ = ["MNN", "NAF", "UMNN", "UNAF"]


def _net_at(network, x, signal):
    """``network([x, s])[..., 0]``, the signal broadcast beside each ``x``."""
    u = torch.cat(broadcast(x[..., None], signal, ignore=1), dim=-1)
    return network(u)[..., 0]


def _with_params(module, params):
    """``module`` as a function of ``u`` with ``params`` in place of its
    parameters, in ``module.parameters()``'s order."""
    names = [name for name, _ in module.named_parameters()]
    return lambda u: torch.func.functional_call(module, dict(zip(names, params)), (u,))


class _MonotonicNetTransform(MonotonicTransform):
    """The monotone transformation :math:`x \\mapsto \\text{net}([x, s])` of a
    stacked :class:`MonotonicMLP` and a per-feature signal ``s`` (reference:
    zuko/flows/neural.py:55-60). The signal and the network's parameters are
    the ``phi`` of the implicit-function backward of the inverse."""

    def __init__(self, network, signal, bound: float = 10.0, eps: float = 1e-6):
        super().__init__(None, (signal, *network.parameters()), bound=bound, eps=eps)
        self.network = network
        self.signal = signal

    def f(self, x):
        return _net_at(self.network, x, self.signal)

    def f_phi(self, x, phi):
        signal, *params = phi
        return _net_at(_with_params(self.network, params), x, signal)


class MNN(nn.Module):
    r"""Monotonic neural network: positive internal weights shared across
    contexts, one network per feature (``stack``), modulated by a signal
    vector (reference: zuko/flows/neural.py:32-71). Further keyword
    arguments go to the :class:`MonotonicMLP`.

    Calling an instance with a signal ``(*, stack, signal)`` returns a
    :class:`~zuko_tpu_torch.transforms.MonotonicTransform`.
    """

    def __init__(self, signal: int = 16, stack: int = None, **kwargs):
        super().__init__()
        self.network = MonotonicMLP(1 + signal, 1, stack=stack, **kwargs)

    def forward(self, signal):
        return _MonotonicNetTransform(self.network, signal)


class _UMNNTransform(UnconstrainedMonotonicTransform):
    r"""The integral of :math:`g(u) = \exp(d / (1 + |d / 7|))`, ``d`` the
    integrand network's output at ``[u, s]``, so :math:`g \in [e^{-7},
    e^7]` (reference: zuko/flows/neural.py:100-104). The signal and the
    network's parameters are the ``phi`` of the inverse's implicit-function
    backward."""

    def __init__(self, integrand, signal, n: int = 32, **kwargs):
        super().__init__(None, n=n, phi=(signal, *integrand.parameters()), **kwargs)
        self.integrand = integrand
        self.signal = signal

    def g(self, x):
        return self._g(self.integrand, x, self.signal)

    def f_phi(self, x, phi):
        signal, *params = phi
        integrand = _with_params(self.integrand, params)
        return gauss_legendre(
            lambda u: self._g(integrand, u, signal), torch.zeros_like(x), x, n=self.n
        )

    @staticmethod
    def _g(integrand, x, signal):
        d = _net_at(integrand, x, signal)
        return torch.exp(d / (1 + torch.abs(d / 7)))


class UMNN(nn.Module):
    r"""Unconstrained monotonic neural network: an integrand network of
    ``1 + signal`` inputs with ELU activations, one per feature (``stack``),
    whose integral from 0 is the monotone map (reference:
    zuko/flows/neural.py:74-118). Further keyword arguments go to the
    :class:`~zuko_tpu_torch.nn.MLP`.

    Calling an instance with ``(signal, constant)`` returns the integral
    transform followed by :class:`~zuko_tpu_torch.transforms.AdditiveTransform`
    of ``constant``.
    """

    def __init__(self, signal: int = 16, stack: int = None, **kwargs):
        super().__init__()
        kwargs.setdefault("activation", torch.nn.functional.elu)
        self.integrand = MLP(1 + signal, 1, stack=stack, **kwargs)

    def forward(self, signal, constant):
        return ComposedTransform(
            _UMNNTransform(self.integrand, signal), AdditiveTransform(constant)
        )


def _interleaved_flow(features, context, transforms, randperm, univariate_factory, shapes,
                      device, **kwargs):
    """The layers and base of the neural flows: ``transforms``
    autoregressive layers with alternating (or, with ``randperm``, random)
    orders, a ``SoftclipTransform(bound=11)`` between consecutive ones, and a
    standard-normal base held as buffers."""
    orders = [np.arange(features), np.arange(features)[::-1]]
    layers = [
        MaskedAutoregressiveTransform(
            features=features,
            context=context,
            order=torch.randperm(features).numpy() if randperm else orders[i % 2],
            univariate=univariate_factory(),
            shapes=shapes,
            device=device,
            **kwargs,
        )
        for i in range(transforms)
    ]
    # a softclip between the layers keeps every feature inside the solve
    # domain of the next layer's inverse (reference: zuko/flows/neural.py:172-173)
    for i in reversed(range(1, len(layers))):
        layers.insert(i, UnconditionalTransform(SoftclipTransform, bound=11.0))
    base = UnconditionalDistribution(
        DiagNormal,
        torch.zeros(features, device=device),
        torch.ones(features, device=device),
        buffer=True,
    )
    return layers, base


class NAF(Flow):
    r"""Neural autoregressive flow (Huang et al., 2018): masked
    autoregressive layers whose univariates are :class:`MNN` monotone
    networks of ``signal`` inputs besides ``x``, with a softclip between the
    layers (reference: zuko/flows/neural.py:121-182). ``network`` holds the
    keyword arguments of the monotone networks (e.g. ``hidden_features``);
    further keyword arguments go to the MADE hyper-networks. Built on
    ``device`` (default ``cuda``; see :func:`zuko_tpu_torch.utils.resolve_device`).

    Warning:
        Invertibility is only guaranteed within :math:`[-10, 10]`;
        standardize features before training.

    Example:
        >>> flow = NAF(3, transforms=2, signal=8, device="cpu")
        >>> x = torch.tensor([[0.1, -0.5, 0.3]])
        >>> flow(None).log_prob(x).shape
        torch.Size([1])
    """

    def __init__(
        self,
        features: int,
        context: int = 0,
        transforms: int = 3,
        randperm: bool = False,
        signal: int = 16,
        network: dict = None,
        device=None,
        **kwargs,
    ):
        device = resolve_device(device)
        network = {} if network is None else dict(network)
        layers, base = _interleaved_flow(
            features, context, transforms, randperm,
            lambda: MNN(signal=signal, stack=features, device=device, **network),
            [(signal,)],
            device,
            **kwargs,
        )
        super().__init__(layers, base)


class UNAF(Flow):
    r"""Unconstrained neural autoregressive flow (Wehenkel et al., 2019):
    masked autoregressive layers whose univariates are :class:`UMNN`
    integrals of ``signal`` inputs besides ``x`` plus a constant, with a
    softclip between the layers (reference: zuko/flows/neural.py:185-246).
    ``network`` holds the keyword arguments of the integrand networks;
    further keyword arguments go to the MADE hyper-networks. Built on
    ``device`` (default ``cuda``; see :func:`zuko_tpu_torch.utils.resolve_device`).

    Example:
        >>> flow = UNAF(3, transforms=2, signal=8, device="cpu")
        >>> x = torch.tensor([[0.1, -0.5, 0.3]])
        >>> flow(None).log_prob(x).shape
        torch.Size([1])
    """

    def __init__(
        self,
        features: int,
        context: int = 0,
        transforms: int = 3,
        randperm: bool = False,
        signal: int = 16,
        network: dict = None,
        device=None,
        **kwargs,
    ):
        device = resolve_device(device)
        network = {} if network is None else dict(network)
        layers, base = _interleaved_flow(
            features, context, transforms, randperm,
            lambda: UMNN(signal=signal, stack=features, device=device, **network),
            [(signal,), ()],
            device,
            **kwargs,
        )
        super().__init__(layers, base)
