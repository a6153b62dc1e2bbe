"""Weight bridge between the JAX package's flax variables and this package's
``state_dict``.

The port names its submodules after the flax paths, so the mapping is a
rename plus a transpose:

=============================================  ===================================
flax ``params/<path>/kernel`` (in, out)        ``<path>.weight`` (out, in)
flax ``params/<path>/mlp_rpe1/conv/kernel``    ``<path>.mlp_rpe1.conv.kernel`` (10, half), whole
flax ``params/<path>/bias``                    ``<path>.bias``
flax ``params/<bn>/scale``                     ``<bn>.weight``
flax ``batch_stats/<bn>/mean`` / ``var``       ``<bn>.running_mean`` / ``running_var``
=============================================  ===================================

The Adam state maps the same way: optax's ``ScaleByAdamState`` holds
``count`` and a ``mu`` and ``nu`` tree shaped like ``params``; torch's Adam
keeps per parameter ``step``, ``exp_avg`` and ``exp_avg_sq``
(:func:`adam_state_from_optax`, :func:`adam_state_to_optax`).
"""

from typing import Dict, Mapping

import numpy as np
import torch

_RPE_KERNEL = "mlp_rpe1.conv.kernel"


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def from_flax_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` numpy tree -> this package's state_dict
    (float32 CPU tensors)."""
    state = {}
    for path, value in _flatten(variables.get("params", {})).items():
        module, leaf = path.rsplit(".", 1)
        if leaf == "kernel" and not path.endswith(_RPE_KERNEL):
            name, value = f"{module}.weight", value.T
        elif leaf == "kernel":
            name = path
        elif leaf == "scale":
            name = f"{module}.weight"
        elif leaf == "bias":
            name = path
        else:
            raise KeyError(f"unexpected flax parameter {path}")
        state[name] = torch.tensor(np.ascontiguousarray(value), dtype=torch.float32)
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        module, leaf = path.rsplit(".", 1)
        stat = {"mean": "running_mean", "var": "running_var"}[leaf]
        state[f"{module}.{stat}"] = torch.tensor(np.asarray(value), dtype=torch.float32)
    return state


def to_flax_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """This package's state_dict -> the ``{"params", "batch_stats"}`` numpy
    tree the JAX package saves (the inverse of :func:`from_flax_variables`)."""
    bn_modules = {
        k.rsplit(".", 1)[0] for k in state_dict if k.endswith(".running_mean")
    }
    tree: Dict = {"params": {}, "batch_stats": {}}

    def put(col: str, path: str, value: np.ndarray):
        node = tree[col]
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value, dtype=np.float32)

    for name, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy()
        module, leaf = name.rsplit(".", 1)
        if leaf == "running_mean":
            put("batch_stats", f"{module}.mean", value)
        elif leaf == "running_var":
            put("batch_stats", f"{module}.var", value)
        elif leaf == "weight" and module in bn_modules:
            put("params", f"{module}.scale", value)
        elif leaf == "weight":
            put("params", f"{module}.kernel", value.T)
        elif leaf in ("bias", "kernel"):
            put("params", name, value)
        else:
            raise KeyError(f"unexpected state_dict entry {name}")
    return tree


def adam_state_to_optax(optimizer: torch.optim.Adam, module: torch.nn.Module) -> Dict:
    """A torch Adam's state over ``module``'s parameters as optax's
    ``ScaleByAdamState`` fields: ``{"count": int32 array, "mu": params
    tree, "nu": params tree}`` (numpy). Parameters without state yet map to
    zeros, as optax initialises them."""
    mu, nu, count = {}, {}, 0
    for name, param in module.named_parameters():
        state = optimizer.state.get(param, {})
        zeros = torch.zeros_like(param)
        mu[name] = state.get("exp_avg", zeros)
        nu[name] = state.get("exp_avg_sq", zeros)
        if "step" in state:
            count = int(state["step"])
    # the buffers tell BatchNorm scales from Dense kernels
    buffers = dict(module.named_buffers())
    return {
        "count": np.asarray(count, np.int32),
        "mu": to_flax_variables({**mu, **buffers})["params"],
        "nu": to_flax_variables({**nu, **buffers})["params"],
    }


def adam_state_from_optax(optimizer: torch.optim.Adam, module: torch.nn.Module,
                          opt_state: Mapping) -> None:
    """Load optax's ``ScaleByAdamState`` fields (``count``, ``mu``, ``nu``:
    numpy trees shaped like ``params``) into a torch Adam over ``module``'s
    parameters, in place."""
    mu = from_flax_variables({"params": opt_state["mu"]})
    nu = from_flax_variables({"params": opt_state["nu"]})
    step = float(np.asarray(opt_state["count"]))
    for name, param in module.named_parameters():
        optimizer.state[param] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(param.device).clone(),
            "exp_avg_sq": nu[name].to(param.device).clone(),
        }
