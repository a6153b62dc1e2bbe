"""Seeded weights of a configuration, made on the device in one draw.

One ``torch.Generator`` on the run's device, seeded from ``--seed``, draws
every parameter and running statistic of :func:`reference.params.layout`
as one uniform vector, which is then cut and scaled by kind. The same
tensors go to the program (as its state dict) and to the reference.

The Dense kernels are drawn at He's scale, U(±sqrt(6 / fan_in)), and the
BatchNorm statistics away from the identity, so that activations keep their
size through the layers and the served confidences spread on both sides of
the threshold (at the default init they sit within 0.005 of 0.5).
"""

import math
from typing import Dict

import torch

from portbench.reference.params import layout


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    entries = layout(cfg)
    total = sum(math.prod(shape) for _, shape, _ in entries)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in entries:
        n = math.prod(shape)
        x = u[at:at + n].reshape(shape)
        at += n
        if kind == "dense":
            x = (2 * x - 1) * math.sqrt(6.0 / shape[1])
        elif kind == "rpe":
            x = (2 * x - 1) * math.sqrt(6.0 / shape[0])
        elif kind in ("bias", "bn_bias", "bn_mean"):
            x = (2 * x - 1) * 0.1
        else:  # bn_weight, bn_var
            x = x + 0.5
        out[name] = x
    return out
