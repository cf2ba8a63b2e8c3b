r"""The weight bridge from ``zuko_tpu`` checkpoints.

:func:`load_params` reads the ``.npz`` that ``zuko_tpu.serial.save_params``
writes (dotted names, parameters and buffers) into a port module's
``state_dict``. The dotted names line up one to one, except the
``UnconditionalDistribution`` arguments: ``zuko_tpu`` names them
``args.0``, ``args.1``, and a torch buffer name cannot contain ``.``, so the
port names them ``_0``, ``_1`` (zuko's names). :data:`RENAMES` is that
table.
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

__all__ = ["RENAMES", "load_params", "to_torch_name"]

#: npz name suffix -> state_dict name suffix
RENAMES = {"args.0": "_0", "args.1": "_1"}


def to_torch_name(name: str) -> str:
    """The ``state_dict`` key of a ``zuko_tpu`` dotted parameter name."""
    for old, new in RENAMES.items():
        if name == old or name.endswith("." + old):
            return name[: len(name) - len(old)] + new
    return name


def load_params(module: torch.nn.Module, path_or_dict: Union[str, Mapping]) -> torch.nn.Module:
    """Load a ``zuko_tpu.serial.save_params`` checkpoint (a path or a mapping
    of names to arrays) into ``module`` in place, each array cast to the
    dtype and device of the entry it replaces. Returns ``module``.

    Raises:
        KeyError: if a checkpoint key matches no entry of the module, or an
            entry of the module has no checkpoint key.
    """
    if isinstance(path_or_dict, Mapping):
        arrays = dict(path_or_dict)
    else:
        with np.load(path_or_dict) as data:
            arrays = {k: data[k] for k in data.files}
    state = module.state_dict()
    mapped = {}
    for name, array in arrays.items():
        key = to_torch_name(name)
        if key in mapped:
            raise KeyError(f"checkpoint keys map twice onto '{key}'")
        mapped[key] = array
    unexpected = sorted(set(mapped) - set(state))
    missing = sorted(set(state) - set(mapped))
    if unexpected or missing:
        raise KeyError(
            f"checkpoint does not match the module: unexpected {unexpected},"
            f" missing {missing}"
        )
    module.load_state_dict({
        k: torch.as_tensor(np.asarray(v), dtype=state[k].dtype, device=state[k].device)
        for k, v in mapped.items()
    })
    return module
