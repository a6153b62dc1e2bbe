"""The harness is driven by data: a cell, its traffic and limits, and a
per-layer metric are added as new files and entries, and nothing that is
there is edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_a_cell_and_a_metric_added_as_new_files_only(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "traffic" / "serve-b2.json").write_text(json.dumps(dict(
        json.loads((pb / "traffic" / "serve-b8.json").read_text()), batch=2)))
    (pb / "limits" / "rl64k-serve-b2.json").write_text(json.dumps({"mask_mismatch_share": 0.5}))
    (pb / "metrics" / "calls.serve-b2.py").write_text(
        '"""Calls in the untraced window."""\n\n\ndef read(r):\n    return len(r.call_s)\n')
    bench["workloads"].append({"name": "rl64k-serve-b2", "config": "rl64k",
                               "traffic": "serve-b2", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "clouds_per_s":
            m["workloads"].append("rl64k-serve-b2")
    bench["per_layer"].append({"name": "calls.serve-b2", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "entry", "moves":
                               "clouds_per_s", "workloads": ["rl64k-serve-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "from portbench import spec, run, drivers\n"
        "c = spec.load('rl64k-serve-b2')\n"
        "d = drivers.make(c.config, c.traffic, c.limits, 1, 'cpu')\n"
        "r = run.Reading(c.config, c.traffic, [0.1, 0.2, 0.3], d.clouds_per_call)\n"
        "print(d.clouds_per_call, [m['name'] for m in c.end_to_end],"
        " [run.read_metric(m['name'], r) for m in c.per_layer])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, check=True,
                         env={"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["2", "['clouds_per_s',", "'setup_s']", "[3]"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())  # nothing edited


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
