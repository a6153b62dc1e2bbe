"""Model FLOPs of RandLA-Net from its shapes: every Dense (the LocSE, the
attention scores, the MLPs, the decoder and the head), two operations a
multiply-add. The neighbour searches, gathers, softmaxes, BatchNorms and
the pooled sums are not counted. A train step counts three forwards."""


def level_sizes(cfg: dict, n: int):
    return [n // cfg["decimation"] ** i for i in range(len(cfg["layer_sizes"]) + 1)]


def forward(cfg: dict, n: int) -> float:
    """FLOPs of one cloud's forward at ``n`` points."""
    k, sizes = cfg["n_neighbors"], level_sizes(cfg, n)
    flops = 2 * n * (3 + cfg["n_features"]) * 8
    n_in = 8
    for rows, n_out in zip(sizes, cfg["layer_sizes"]):
        half = n_out // 2
        flops += 2 * rows * (
            n_in * half                 # mlp1
            + k * 10 * half             # LocSE Dense
            + k * n_out * n_out         # pool 1 scores
            + n_out * half              # pool 1 MLP
            + k * half * half           # mlp_rpe2
            + k * n_out * n_out         # pool 2 scores
            + n_out * n_out             # pool 2 MLP
            + n_out * 2 * n_out         # mlp2
            + n_in * 2 * n_out          # shortcut
        )
        n_in = 2 * n_out
    flops += 2 * sizes[-1] * n_in * n_in
    layers = cfg["layer_sizes"]
    outs = [2 * s for s in layers[::-1][1:]] + [8]
    skips = [2 * s for s in layers[::-1]]
    for rows, n_out, skip in zip(sizes[-2::-1], outs, skips):
        flops += 2 * rows * (n_in + skip) * n_out
        n_in = n_out
    flops += 2 * n * (8 * 64 + 64 * 32 + 32 * cfg["n_classes"])
    return float(flops)


def train_step(cfg: dict, n: int, batch: int) -> float:
    """FLOPs of one train step: forward, and a backward counted as two."""
    return 3.0 * batch * forward(cfg, n)
