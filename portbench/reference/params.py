"""The parameter layout of RandLA-Net (Hu et al., arXiv:1911.11236) as the
benchmark's configurations state it: every tensor's name, shape and kind.

The names are those of the measured package's state dict, so one set of
seeded tensors is handed to both sides. Kinds:

- ``dense``: a Dense kernel (out, in), drawn U(±sqrt(6 / in));
- ``rpe``: the LocSE Dense kernel (10, half) over ``[centre, neighbour,
  centre − neighbour, distance]``, drawn U(±sqrt(6 / 10));
- ``bias``: a Dense bias, U(±0.1);
- ``bn_weight`` / ``bn_var``: U(0.5, 1.5); ``bn_bias`` / ``bn_mean``: U(±0.1).
"""

from typing import List, Tuple

Entry = Tuple[str, Tuple[int, ...], str]


def _bn(prefix: str, n: int) -> List[Entry]:
    return [(f"{prefix}.weight", (n,), "bn_weight"), (f"{prefix}.bias", (n,), "bn_bias"),
            (f"{prefix}.running_mean", (n,), "bn_mean"), (f"{prefix}.running_var", (n,), "bn_var")]


def _mlp(prefix: str, n_in: int, n_out: int, bn: bool = True) -> List[Entry]:
    out = [(f"{prefix}.conv.weight", (n_out, n_in), "dense"),
           (f"{prefix}.conv.bias", (n_out,), "bias")]
    return out + (_bn(f"{prefix}.batch_norm", n_out) if bn else [])


def layout(cfg: dict) -> List[Entry]:
    """Every parameter and running statistic of the configuration, in a fixed
    order."""
    sizes = cfg["layer_sizes"]
    out = [("fc_start.weight", (8, 3 + cfg["n_features"]), "dense"),
           ("fc_start.bias", (8,), "bias")] + _bn("bn_start", 8)
    n_in = 8
    for i, n_out in enumerate(sizes):
        p, half = f"encoder_{i}", n_out // 2
        out += _mlp(f"{p}.mlp1", n_in, half)
        out += [(f"{p}.mlp_rpe1.conv.kernel", (10, half), "rpe"),
                (f"{p}.mlp_rpe1.conv.bias", (half,), "bias")]
        out += _bn(f"{p}.mlp_rpe1.batch_norm", half)
        out += [(f"{p}.pool1.score_fn.weight", (n_out, n_out), "dense")]
        out += _mlp(f"{p}.pool1.mlp", n_out, half)
        out += _mlp(f"{p}.mlp_rpe2", half, half)
        out += [(f"{p}.pool2.score_fn.weight", (n_out, n_out), "dense")]
        out += _mlp(f"{p}.pool2.mlp", n_out, n_out)
        out += _mlp(f"{p}.mlp2", n_out, 2 * n_out)
        out += _mlp(f"{p}.shortcut", n_in, 2 * n_out)
        n_in = 2 * n_out
    out += _mlp("mlp", n_in, n_in)
    decoder_channels = [2 * n for n in sizes[::-1][1:]] + [8]
    skips = [2 * n for n in sizes[::-1]]
    for i, (n_out, skip) in enumerate(zip(decoder_channels, skips)):
        out += _mlp(f"decoder_{i}", n_in + skip, n_out)
        n_in = n_out
    out += _mlp("fc_end_0", 8, 64) + _mlp("fc_end_1", 64, 32)
    out += _mlp("fc_end_2", 32, cfg["n_classes"], bn=False)
    return out
