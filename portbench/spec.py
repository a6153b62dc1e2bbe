"""A cell of ``BENCHMARK.json`` and the files it names, found by name:

- ``BENCHMARK.json`` (the checkout's root): the cell, its configuration's
  file, and the metrics that list it (or, without ``workloads``, that move
  one of its end-to-end metrics);
- ``portbench/traffic/<traffic>.json``: the traffic mix's parameters;
- ``portbench/limits/<cell>.json``: the limit of each number compared.
"""

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int = 1
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _lists(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in {bench_path}; there are {sorted(work)}")
    w = work[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _lists(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(
        name=name,
        config=json.loads((ROOT / entry["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        chips=w["chips"], end_to_end=e2e, per_layer=per_layer,
    )
