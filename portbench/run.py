"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, inputs and weights from the seed, the model, the warm-up
of every shape the cell's traffic uses) is ``setup_s``. The window is a
closed loop of calls for ``--seconds``; with ``--trace 1`` the same window
runs untraced, then ``trace_calls`` more calls under ``torch.profiler``,
and the line carries the per-layer metrics instead of the end-to-end ones.
After the window the program's state is freed and a sample of the calls,
drawn from the seed, is compared with the plain reference; each number
compared is printed beside its limit, on standard error and under
``checks``, the last key of the result's line (standard output's last
line).

The run needs as many CUDA devices as the cell asks for; without them it
exits with code 2 and prints no result. It also refuses to print a result
(code 3) if JAX, jaxlib, flax or the JAX package were loaded in the process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import List, Optional  # noqa: E402

import torch  # noqa: E402

from portbench import drivers, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "recognizer3d_tpu")


@dataclass
class Reading:
    """What a per-layer metric reads: the cell's configuration and traffic,
    the untraced window's call times (s), the traced session, and the calls
    and clouds it covered."""

    config: dict
    traffic: dict
    call_s: List[float]
    clouds_per_call: int
    trace: Optional["trace.Trace"] = None
    traced_calls: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def traced_clouds(self) -> int:
        return self.traced_calls * self.clouds_per_call


def read_metric(name: str, reading: Reading):
    path = spec.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read(reading)


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device: str = "cuda", t0: float = T0) -> int:
    """One run of ``cell``; prints the result's line and returns the exit
    code (0 when a result was printed)."""
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"no card: the cell needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    driver = drivers.make(cell.config, cell.traffic, cell.limits, seed, device)
    win = driver.run(seconds, traced)
    setup_s = win.setup_end - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    reading = Reading(cell.config, cell.traffic, win.times, driver.clouds_per_call,
                      win.trace, win.traced_calls, driver.reading_extra(win))
    driver.release()
    checks = driver.verify()
    correct = win.failed == 0 and all(value <= limit for _, value, limit in checks)
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(m["name"], reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(driver.end_to_end(win), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    calls = win.calls + win.traced_calls
    result = {"correct": correct, "attempted": calls * driver.clouds_per_call,
              "failed": win.failed * driver.clouds_per_call, "metrics": metrics, "device": dev}
    if traced and reading.trace is not None:
        dev["busy_s"] = reading.trace.busy_s
        dev["window_s"] = reading.trace.window_s
        result["breakdown"] = {"device_ops": reading.trace.device_ops(),
                               "idle_gaps": reading.trace.idle_gaps()}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    print(f"calls {win.calls} in the window of {win.window_s:.3f} s; set-up {setup_s:.3f} s; "
          f"card {power_limit() if device == 'cuda' else 'none'}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    return execute(spec.load(args.workload), args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
