r"""Continuous normalizing flows (CNF, FFJORD).

Counterpart of ``zuko_tpu/flows/continuous.py``: the dynamics
:func:`_ffj_dynamics` :24, :class:`FFJTransform` :38 (an ODE network with a
sinusoidal time embedding, wrapped in a
:class:`~zuko_tpu_torch.transforms.FreeFormJacobianTransform`) and the
:class:`CNF` recipe :101.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from ..distributions import DiagNormal
from ..lazy import Flow, LazyTransform, UnconditionalDistribution
from ..nn import MLP
from ..transforms import FreeFormJacobianTransform
from ..utils import broadcast, resolve_device

__all__ = ["CNF", "FFJTransform"]


def _ffj_dynamics(t, x, phi):
    """The CNF dynamics: the ODE network on ``[cos(f t), sin(f t), x, c]``.
    Everything it reads arrives through ``phi`` (``ode``, its ``params`` by
    name, ``freqs``, ``c``), so the integrator's adjoint reaches the
    network's parameters and the context."""
    te = phi["freqs"] * t[..., None]
    te = torch.cat([torch.cos(te), torch.sin(te)], dim=-1)
    c = phi["c"]
    parts = broadcast(te, x, ignore=1) if c is None else broadcast(te, x, c, ignore=1)
    return torch.func.functional_call(phi["ode"], phi["params"], (torch.cat(parts, dim=-1),))


class FFJTransform(LazyTransform):
    r"""Lazy free-form Jacobian transformation: the ODE network is
    ``MLP(2 freqs + features + context, features)`` with ELU activations,
    under the time embedding :math:`\cos(k \pi t), \sin(k \pi t)` for
    :math:`k = 1, \dots,` ``freqs`` (reference:
    zuko/flows/continuous.py:23-113). With ``exact=False`` the trace is
    Hutchinson's, and the probe's seed is drawn from the ``generator`` that
    ``flow(c, generator=g)`` hands down. Built on ``device`` (default
    ``cuda``; see :func:`zuko_tpu_torch.utils.resolve_device`).

    Example:
        >>> t = FFJTransform(3, 4, device="cpu")
        >>> x = torch.tensor([0.6, -0.3, 1.1])
        >>> y = t(torch.ones(4))(x)
        >>> bool(torch.allclose(t(torch.ones(4)).inv(y), x, atol=1e-4))
        True
    """

    def __init__(
        self,
        features: int,
        context: int = 0,
        freqs: int = 3,
        atol: float = 1e-6,
        rtol: float = 1e-5,
        exact: bool = True,
        max_steps: int = 256,
        device=None,
        **kwargs,
    ):
        super().__init__()
        device = resolve_device(device)
        kwargs.setdefault("activation", Fn.elu)
        self.ode = MLP(features + context + 2 * freqs, features, device=device, **kwargs)
        self.register_buffer(
            "freqs", torch.arange(1, freqs + 1, dtype=torch.float32, device=device) * math.pi)
        self.atol = float(atol)
        self.rtol = float(rtol)
        self.exact = bool(exact)
        self.max_steps = int(max_steps)

    def forward(self, c: torch.Tensor = None, generator: torch.Generator = None):
        if self.exact:
            seed = None
        elif generator is None:
            raise ValueError(
                "FFJTransform(exact=False) needs a generator for the Hutchinson trace:"
                " call the flow as flow(c, generator=g)")
        else:
            seed = int(torch.randint(1 << 62, (), generator=generator, device=generator.device))
        return FreeFormJacobianTransform(
            _ffj_dynamics, 0.0, 1.0,
            {"ode": self.ode, "params": dict(self.ode.named_parameters()),
             "freqs": self.freqs, "c": c},
            self.atol, self.rtol, self.exact, seed, self.max_steps,
        )


class CNF(Flow):
    r"""Continuous normalizing flow (Chen et al., 2018; Grathwohl et al.,
    2018): one :class:`FFJTransform` over a standard normal base (reference:
    zuko/flows/continuous.py:116-152). Built on ``device`` (default
    ``cuda``); further keyword arguments go to :class:`FFJTransform`.

    Example:
        >>> flow = CNF(2, device="cpu")
        >>> flow(None).log_prob(torch.tensor([[0.1, -0.2]])).shape
        torch.Size([1])
    """

    def __init__(self, features: int, context: int = 0, device=None, **kwargs):
        device = resolve_device(device)
        transform = FFJTransform(features, context, device=device, **kwargs)
        base = UnconditionalDistribution(
            DiagNormal,
            torch.zeros(features, device=device),
            torch.ones(features, device=device),
            buffer=True,
        )
        super().__init__(transform, base)
