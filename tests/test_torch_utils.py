r"""The port's root solvers (``zuko_tpu_torch.utils.bisection`` and
``newton_bisection``) against ``zuko_tpu.utils``: values, and gradients to the
target and to the parameters through the implicit-function rule.

The same ``y`` and parameters, made with numpy from a seed, go to both
packages in float64 on the CPU, with the same iteration counts. Both sides
take the same decisions at every step, so the roots agree to roundoff and
the gradients, ``g / f'(x*)`` and its pullback, to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zuko_tpu import utils as jax_utils
from zuko_tpu_torch import utils as torch_utils

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _leave_torch_globals_as_found():
    """Other tests of the suite draw from torch's global generator unseeded
    and set its default dtype: run on float32 defaults, and hand both back
    as they were."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_default_dtype(dtype)


def _problem(seed=0, n=24):
    """``f(x) = a x^3 + b x`` with positive ``a``, ``b`` per element, and
    targets inside ``f([-3, 3])``."""
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(0.2, 1.5, n), rng.uniform(0.5, 2.0, n)
    x = rng.uniform(-2.5, 2.5, n)
    return a, b, a * x**3 + b * x, rng.standard_normal(n)


SOLVERS = {
    "bisection": (jax_utils.bisection, torch_utils.bisection, {"n": 45}),
    "newton_bisection": (
        jax_utils.newton_bisection, torch_utils.newton_bisection, {"n": 40, "xtol": 1e-12}),
}


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_matches_zuko_tpu(solver):
    jsolve, tsolve, kwargs = SOLVERS[solver]
    a, b, y, w = _problem()

    def jloss(y_, phi):
        x = jsolve(lambda x, p: p[0] * x**3 + p[1] * x, y_, -3.0, 3.0, phi=phi, **kwargs)
        return jnp.sum(x * w), x

    (_, jx), (jgy, jgphi) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(y), (jnp.asarray(a), jnp.asarray(b)))

    ty, ta, tb = (torch.tensor(v, requires_grad=True) for v in (y, a, b))
    tx = tsolve(lambda x: ta * x**3 + tb * x, ty, -3.0, 3.0, phi=(ta, tb), **kwargs)
    (tx * torch.as_tensor(w)).sum().backward()

    assert tx.dtype == torch.float64 and tx.shape == y.shape
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(a * np.asarray(jx) ** 3 + b * np.asarray(jx), y, atol=1e-9)
    for got, want in ((ty.grad, jgy), (ta.grad, jgphi[0]), (tb.grad, jgphi[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_without_phi_differentiates_to_the_target_only(solver):
    """``phi`` empty: the gradient reaches ``y``; tensors that ``f`` closes
    over receive none (they were not handed in), as in ``zuko_tpu``."""
    _, tsolve, kwargs = SOLVERS[solver]
    a, b, y, w = _problem(seed=1)
    ta = torch.tensor(a, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    tx = tsolve(lambda x: ta * x**3 + torch.as_tensor(b) * x, ty, -3.0, 3.0, **kwargs)
    (tx * torch.as_tensor(w)).sum().backward()
    x = tx.detach().numpy()
    np.testing.assert_allclose(ty.grad.numpy(), w / (3 * a * x**2 + b), rtol=1e-9, atol=1e-9)
    assert ta.grad is None


def test_newton_bisection_ends_early_and_keeps_the_bracket():
    """The host-side loop stops once every element has converged: far fewer
    evaluations of ``f`` than ``n``, the root still inside the tolerance; a
    target outside ``f([a, b])`` pegs at the bracket's end."""
    calls = []

    def f(x):
        calls.append(1)
        return x**3 + x

    y = torch.tensor([10.0, -2.0, 0.3], dtype=torch.float64)
    x = torch_utils.newton_bisection(f, y, -3.0, 3.0, n=64, xtol=1e-10)
    np.testing.assert_allclose((x**3 + x).numpy(), y.numpy(), atol=1e-8)
    assert len(calls) < 20
    pegged = torch_utils.newton_bisection(f, torch.tensor([1e3], dtype=torch.float64), -3.0, 3.0)
    np.testing.assert_allclose(pegged.numpy(), [3.0], atol=1e-6)


def test_solvers_promote_and_broadcast_their_bracket():
    y = torch.tensor([[0.5, 1.0], [2.0, 8.0]])
    x = torch_utils.bisection(lambda x: x**3, y, 0.0, torch.tensor(10.0), n=40)
    assert x.dtype == torch.float32 and x.shape == (2, 2)
    np.testing.assert_allclose(x.numpy() ** 3, y.numpy(), rtol=1e-4)
