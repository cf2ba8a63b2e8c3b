r"""Training harness: maximum likelihood and reverse-KL variational inference.

Counterpart of ``zuko_tpu/parallel/train.py``. The reference keeps training in
tutorial notebooks (docs/tutorials/forward_kl.ipynb cell 9, reverse_kl.ipynb
cell 9); here it is a library component. PyTorch's idiom inside: the flow
``nn.Module`` holds the parameters and is updated in place, the optimizer is
``torch.optim.Adam`` (the arithmetic of ``optax.adam``: eps 1e-8 outside the
square root, bias correction, no weight decay), and a
:class:`TrainState` carries the two with the step count. On the GPU the
steps run the fused kernels: ``log_prob`` through ``nsf_density``,
``rsample_and_log_prob`` through ``nsf_sample`` and the IFT backward
(:mod:`zuko_tpu_torch.ops.ift`), or through ``nsf_apply`` for an inverted
flow.
"""

from __future__ import annotations

import copy
import time

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["TrainState", "make_mle_step", "make_reverse_kl_step", "train_mle"]

_MESH = (
    "the device mesh and data-parallel training are not ported yet"
    " (ROADMAP.md, Queue 1 item 10); pass mesh=None"
)


class TrainState(NamedTuple):
    flow: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def _make_step(flow, loss_fn, lr):
    """``init_fn, step_fn`` around ``loss_fn(flow, *args) -> scalar``."""

    def init_fn() -> TrainState:
        params = [p for p in flow.parameters() if p.requires_grad]
        return TrainState(flow, torch.optim.Adam(params, lr=lr), 0)

    def step_fn(state: TrainState, *args):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.flow, *args)
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    return init_fn, step_fn


def make_mle_step(flow: torch.nn.Module, lr: float = 1e-3):
    r"""Build ``init_fn, step_fn`` for forward-KL maximum likelihood:
    ``loss = -mean log p(x | c)`` (reference training loop:
    docs/tutorials/forward_kl.ipynb cell 9).

    ``state = init_fn()`` holds ``flow`` itself (trained in place), its
    optimizer (Adam at ``lr``) and the step count; ``step_fn(state, x, c=None)`` takes one step and returns ``(state,
    loss)``, the loss a detached 0-d tensor on the flow's device.
    """

    def loss_fn(flow, x, c=None):
        return -flow(c).log_prob(x).mean()

    return _make_step(flow, loss_fn, lr)


def make_reverse_kl_step(
    flow: torch.nn.Module,
    log_energy: Callable,
    n_samples: int = 256,
    lr: float = 1e-3,
    mesh=None,
):
    r"""Build ``init_fn, step_fn`` for reverse-KL variational inference:
    ``loss = E_q[log q(x)] - E_q[log energy(x)]`` through the fused
    ``rsample_and_log_prob`` (reference: zuko/distributions.py:129-138 and
    docs/tutorials/reverse_kl.ipynb cell 9). ``step_fn(state, generator=None)``
    draws ``n_samples`` from ``flow(None)`` with ``generator`` and returns
    ``(state, loss)``. ``flow`` may be an inverted flow,
    ``Flow(flow.transform.inv, flow.base)``.
    """
    if mesh is not None:
        raise NotImplementedError(_MESH)

    def loss_fn(flow, generator=None):
        x, log_q = flow(None).rsample_and_log_prob((n_samples,), generator)
        return log_q.mean() - log_energy(x).mean()

    return _make_step(flow, loss_fn, lr)


def train_mle(
    flow: torch.nn.Module,
    data,
    context=None,
    epochs: int = 8,
    batch_size: int = 64,
    lr: float = 1e-3,
    generator: torch.Generator = None,
    mesh=None,
    verbose: bool = False,
    callback: Optional[Callable[[dict], None]] = None,
):
    r"""Reference-parity MLE loop (Adam, shuffled minibatches: the tutorial
    recipe, docs/tutorials/forward_kl.ipynb cell 9).

    A copy of ``flow`` is trained; the caller's stays as it was. The dataset
    (and its context) lives on the flow's device, each epoch shuffles it with
    ``torch.randperm(n, generator=generator)`` (a generator of the flow's
    device) and drops the last partial batch. The host waits for the device
    once per epoch, not per step.

    ``callback``, if given, is called once per optimizer step, after its
    epoch, with ``{step, epoch, loss, grad_norm, examples_per_s}``:
    ``grad_norm`` is the global L2 norm of the step's gradient,
    ``examples_per_s`` the epoch's rate.

    Returns ``(trained_flow, per-epoch mean losses)``.
    """
    if mesh is not None:
        raise NotImplementedError(_MESH)
    flow = copy.deepcopy(flow)
    device = next(flow.parameters()).device
    dtype = next(flow.parameters()).dtype
    data = torch.as_tensor(data).to(device=device, dtype=dtype)
    ctx = None if context is None else torch.as_tensor(context).to(device=device, dtype=dtype)
    init_fn, step_fn = make_mle_step(flow, lr=lr)
    state = init_fn()
    params = [p for p in flow.parameters() if p.requires_grad]

    n = data.shape[0]
    n_batches = n // batch_size
    losses = []
    for epoch in range(epochs):
        perm = torch.randperm(n, generator=generator, device=device)
        perm = perm[: n_batches * batch_size].reshape(n_batches, batch_size)
        t0 = time.perf_counter()
        epoch_losses, epoch_gnorms = [], []
        for idx in perm:
            state, loss = step_fn(state, data[idx], None if ctx is None else ctx[idx])
            epoch_losses.append(loss)
            if callback is not None:
                epoch_gnorms.append(torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(p.grad) for p in params])
                ))
        epoch_losses = torch.stack(epoch_losses).cpu()  # waits for the device
        dt = time.perf_counter() - t0
        losses.append(float(epoch_losses.mean()))
        if callback is not None:
            epoch_gnorms = torch.stack(epoch_gnorms).cpu()
            eps = n_batches * batch_size / max(dt, 1e-9)
            for i in range(n_batches):
                callback({
                    "step": state.step - n_batches + i + 1,
                    "epoch": epoch,
                    "loss": float(epoch_losses[i]),
                    "grad_norm": float(epoch_gnorms[i]),
                    "examples_per_s": eps,
                })
        if verbose:
            print(f"epoch {epoch}: loss {losses[-1]:.4f} ± {float(epoch_losses.std()):.3f}")
    return flow, losses
