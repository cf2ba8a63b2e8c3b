r"""Datasets and target energies of the tutorial tasks.

Counterpart of ``zuko_tpu/data.py``: :func:`two_moons` :29 and
:func:`ring_energy` :51. The UCI and digits loaders are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ring_energy", "two_moons"]


def two_moons(n: int, sigma: float = 1e-1, seed: int = 0):
    """Two-moons dataset, the reference tutorial's generator
    (docs/tutorials/forward_kl.ipynb cell 3), as float32 numpy arrays ``(x
    (n, 2), label (n,))``:

    ``theta ~ U(0, 2pi)``, ``label = theta > pi``,
    ``x = (cos t + label - 1/2, sin t + label/2 - 1/4) + N(0, sigma)``.

    The draws come from ``numpy.random.RandomState(seed)``, so the same seed
    gives the same arrays as ``zuko_tpu.data.two_moons``.
    """
    rng = np.random.RandomState(seed)
    theta = 2 * np.pi * rng.rand(n)
    label = (theta > np.pi).astype(np.float64)
    x = np.stack(
        [
            np.cos(theta) + label - 1 / 2,
            np.sin(theta) + label / 2 - 1 / 4,
        ],
        axis=-1,
    )
    x = x + sigma * rng.randn(n, 2)
    return x.astype(np.float32), label.astype(np.float32)


def ring_energy(x: torch.Tensor) -> torch.Tensor:
    r"""The reference reverse-KL tutorial's multi-modal log-energy
    (docs/tutorials/reverse_kl.ipynb cell 3):
    :math:`\log U(x) = \sin(\pi x_1) - 2 (x_1^2 + x_2^2 - 2)^2`."""
    x1, x2 = x[..., 0], x[..., 1]
    return torch.sin(torch.pi * x1) - 2 * (x1**2 + x2**2 - 2) ** 2
