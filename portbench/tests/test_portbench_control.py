"""The control of each cell, on the card at a size a test run holds: the
reference computed with TF32 matmuls, put in the program's place, fails the
cell's limit, where the program passes it. (At the cells' own sizes the
readings come from ``python3 -m portbench.control``; PERF.md keeps them.)

    python -m pytest portbench/tests -m cuda
"""

import json
from pathlib import Path

import pytest

from portbench import drivers

ROOT = Path(__file__).resolve().parents[2]
BASE = dict(n_classes=2, n_features=0, n_neighbors=32, decimation=4,
            layer_sizes=[16, 64, 128, 256], knn="naive", upsampling="nni",
            compute_dtype="float32")


def _limits(cell):
    return json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())


CASES = {
    "serve": (dict(BASE, n_points=16384),
              dict(kind="serve", batch=4, captures=8, capture_points=40000, scale=0.2,
                   threshold=0.5, verify_calls=2, trace_calls=1), "rl64k-serve-b8"),
    "scan": (dict(BASE, n_points=262144),
             dict(kind="scan", rooms=2, room_points=262144, scale=0.2, verify_calls=1,
                  trace_calls=1), "rl1m-scan"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("seed", [2**31 + 5, 17, 99])
def test_the_control_fails_where_the_program_passes(kind, seed, card):
    cfg, traffic, cell = CASES[kind]
    driver = drivers.make(cfg, traffic, _limits(cell), seed, card)
    driver.run(1.0, False)
    driver.release()
    program = driver.verify()
    control = driver.checks(driver.control())
    assert all(value <= limit for _, value, limit in program), program
    assert any(value > limit for _, value, limit in control), control
