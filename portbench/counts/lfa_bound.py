"""The least time (s) the fused LFA kernels B2 (round 1) and B3 (pool 2 with
the block's residual) can take for one cloud: at each encoder level whose
half width they take (8 and 32), the larger of bytes over the HBM rate and
float32 operations over the float32 rate, for each kernel. The counts are
the port's own ``chip_smoke.py`` ``_round1_work`` and ``_pool2_work``,
copied: each input read once, each output written once."""

from portbench.counts import peaks
from portbench.counts.model_flops import level_sizes

FUSED_HALVES = (8, 32)


def round1_work(rows: int, k: int, h: int, elem: int = 4):
    c2 = 2 * h
    nbytes = rows * (elem * (k * c2 + h + k * h) + 4 * (k + h)) + 4 * (5 * h + 7 * h * h)
    dots = 2 * k * c2 * c2 + 2 * c2 * h + 2 * k * h * h
    rest = k + 5 * k * h + 5 * k * c2 + 2 * k * c2 + 2 * h + 2 * k * h
    return nbytes, rows * dots, rows * rest


def pool2_work(rows: int, k: int, h: int, f: int, elem: int = 4):
    c2, c4 = 2 * h, 4 * h
    dots = 2 * k * c2 * c2 + 2 * c2 * c2 + 2 * c2 * c4 + 2 * f * c4
    rest = 5 * k * c2 + 2 * k * c2 + 2 * c2 + 3 * c4
    nbytes = elem * rows * (2 * k * h + f + c4) + 4 * (
        2 * c2 * c2 + c2 + c2 * c4 + f * c4 + c4)
    return nbytes, rows * dots, rows * rest


def _bound(work) -> float:
    nbytes, dots, rest = work
    return max(nbytes / peaks.BYTES_PER_S, (dots + rest) / peaks.F32_OPS_PER_S)


def forward_s(cfg: dict, n: int) -> float:
    k, total, n_in = cfg["n_neighbors"], 0.0, 8
    for rows, n_out in zip(level_sizes(cfg, n), cfg["layer_sizes"]):
        h = n_out // 2
        if h in FUSED_HALVES:
            total += _bound(round1_work(rows, k, h)) + _bound(pool2_work(rows, k, h, n_in))
        n_in = 2 * n_out
    return total
