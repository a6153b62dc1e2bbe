"""Micro-benchmark: the cost of one bitonic compare-exchange stage on the
card (counterpart of ``benchmarks/bench_roll_stages.py``). It decides
whether a bitonic network can beat repeated min-extraction in the KNN
selection.

    python -m recognizer3d_tpu_torch.benchmarks.bench_roll_stages

Runs the B7 kernel (``ops/bitonic_kernels.roll_stages``: S stages of
partner = x[i XOR d], compare, min / max with a payload riding along) on
(n_blocks, qb, ts) float32, in the JAX version's chain: ``iters`` calls of
``c + max(f(x + c·1e-12)[:, :1, :1])``, each reading the previous result.
The chain is timed with CUDA events on the card after one untimed chain,
and the table prints total ms per call, µs per block of qb rows, and the marginal µs per
stage over the 1-stage run, per block.
"""

import numpy as np
import torch

from recognizer3d_tpu_torch.ops.bitonic_kernels import roll_stages
from recognizer3d_tpu_torch.utils.device import resolve_device

STAGES = (1, 5, 15, 45)


def run(stages, qb=128, ts=1024, n_blocks=512, iters=5) -> float:
    """Seconds per call of the chained loop at ``stages`` stages, on the
    card."""
    dev = resolve_device("cuda")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(n_blocks, qb, ts).astype(np.float32)).to(dev)

    def loop():
        c = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(iters):
            c = c + roll_stages(x + c * 1e-12, stages)[:, :1, :1].max()
        return c

    float(loop())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    c = loop()
    end.record()
    float(c)
    return start.elapsed_time(end) / 1e3 / iters


def table(n_blocks=512, **kwargs):
    """[(stages, total ms, per-block µs, marginal µs per stage)] for
    :data:`STAGES`, the marginal taken over a 1-stage run."""
    base = run(1, n_blocks=n_blocks, **kwargs)
    rows = []
    for stages in STAGES:
        dt = run(stages, n_blocks=n_blocks, **kwargs)
        per_block = dt / n_blocks * 1e6
        per_stage = (dt - base) / n_blocks / max(1, stages - 1) * 1e6
        rows.append((stages, dt * 1e3, per_block, per_stage))
    return rows


def main():
    for stages, total_ms, per_block, per_stage in table():
        print(
            f"stages={stages:3d}  total {total_ms:7.2f} ms  "
            f"per-block {per_block:7.2f} us  marginal/stage {per_stage:6.3f} us"
        )


if __name__ == "__main__":
    main()
