"""The card against the CPU port in bfloat16, over several frames and seeds:

    python -m recognizer3d_tpu_torch.benchmarks.bf16_card_vs_cpu \
        [--frames 4] [--seeds 2] [--out PATH]

The bundled ``pretrained/mock_fingertip`` weights with ``bench.py``'s
``settings64a`` (``knn="approximate"``, 65,536 points) and
``compute_dtype="bfloat16"`` answer 150,000-point mock frames (numpy seeds
300, 301, ... as in ``chip_smoke.py``) with ``Model.predict`` on the card
and on the CPU, float32 upload, the same sampling seed on both sides. Each
model first answers a warm-up frame, which runs its recall guard (the
session window is process-global, so both sides then search alike). Per
frame and seed it prints the confidences' max and mean |Δ|, the CPU's
class-1 confidence and the two sides' logit margins log(p1/p0) at the
worst point, and how many points differ by more than 1e-2; then the
largest reading and the spread; then, for the worst reading, each stage of
the network (the outputs of ``RandLANet``'s child modules, in call order):
the share of its elements that differ between the two sides and its max
and mean |Δ| over its max and mean |value|, which shows where the
difference grows. The mask must agree wherever the CPU's
confidence lies more than 0.05 from the threshold; the run fails where it
does not. ``chip_smoke.py`` holds one such frame to a max |Δ| of 2e-2. The
card's name and power limit come first; the record goes to ``--out`` as
JSON. It runs on the card and fails without one.
"""

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
ARCHIVE = ROOT / "pretrained" / "mock_fingertip"
SETTINGS = dict(knn="approximate", n_points=65_536, compute_dtype="bfloat16")
FRAME_POINTS = 150_000
BAND = 0.05


def _stage_outputs(model, frame, seed: int) -> dict:
    """The output of each child module of the model's network that its
    forward calls, in call order, on the CPU as float32."""
    outs = {}
    hooks = [
        child.register_forward_hook(
            lambda _m, _i, out, name=name: outs.__setitem__(name, out.detach().float().cpu())
        )
        for name, child in model.module.named_children()
    ]
    try:
        np.random.seed(seed)
        model.predict(frame)
    finally:
        for hook in hooks:
            hook.remove()
    return outs


def _margin(conf: np.ndarray, i: int) -> float:
    return float(np.log(conf[1, i] / max(conf[0, i], 1e-30)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--seeds", type=int, default=2)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "bf16_card_vs_cpu.json")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bf16_card_vs_cpu: torch.cuda.is_available() is False")
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch.benchmarks.training_parity import _gpu_line
    from recognizer3d_tpu_torch.benchmarks.window_select import _mock_frame
    from recognizer3d_tpu_torch.ops import knn as port_knn

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    port_knn.reset_window_guard()
    card = Model.load(ARCHIVE, device="cuda", **SETTINGS)
    cpu = Model.load(ARCHIVE, device="cpu", **SETTINGS)
    frames = [_mock_frame(FRAME_POINTS, 300 + f, 0.45 * f) for f in range(args.frames)]
    for model in (card, cpu):
        np.random.seed(99)
        model.predict(frames[0])
    print(f"recall guard: card {card.recall_guard_result}, CPU {cpu.recall_guard_result}; "
          f"session window {port_knn.session_window_points()}, exact fallback "
          f"{port_knn.session_exact_fallback()}", flush=True)
    readings = []
    for f, frame in enumerate(frames):
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            np.random.seed(seed)
            conf_gpu = card.predict(frame)
            np.random.seed(seed)
            conf_cpu = cpu.predict(frame)
            diff = np.abs(conf_gpu - conf_cpu)
            worst = int(np.argmax(diff.max(axis=0)))
            near = np.abs(conf_cpu[1] - 0.5) <= BAND
            mask_diff = int(((conf_gpu[1] > 0.5) != (conf_cpu[1] > 0.5))[~near].sum())
            r = {
                "frame": f, "seed": seed, "max": float(diff.max()), "mean": float(diff.mean()),
                "over_1e-2": int((diff.max(axis=0) > 1e-2).sum()),
                "worst_conf_cpu": float(conf_cpu[1, worst]),
                "worst_margin_cpu": _margin(conf_cpu, worst),
                "worst_margin_gpu": _margin(conf_gpu, worst),
                "mask_diff_outside_band": mask_diff,
            }
            readings.append(r)
            print(f"frame {f} seed {seed}: max |Δ| {r['max']:.4g}, mean {r['mean']:.3g}, "
                  f"{r['over_1e-2']} points over 1e-2; worst point: CPU p1 "
                  f"{r['worst_conf_cpu']:.4f}, logit margin CPU {r['worst_margin_cpu']:.4f} "
                  f"card {r['worst_margin_gpu']:.4f}; {mask_diff} mask points differ outside "
                  f"±{BAND} ({time.perf_counter() - t0:.1f} s)", flush=True)
    maxes = [r["max"] for r in readings]
    print(f"max |Δ| over {len(maxes)} readings: largest {max(maxes):.4g}, median "
          f"{statistics.median(maxes):.4g}, smallest {min(maxes):.4g}, stdev "
          f"{statistics.pstdev(maxes):.3g}", flush=True)
    worst = max(readings, key=lambda r: r["max"])
    stages_gpu, stages_cpu = (_stage_outputs(m, frames[worst["frame"]], worst["seed"])
                              for m in (card, cpu))
    stages = []
    for name, ref in stages_cpu.items():
        d = (stages_gpu[name] - ref).abs()
        stage = {"stage": name, "differ": float((d > 0).float().mean()),
                 "max_rel": float(d.max() / ref.abs().max()),
                 "mean_rel": float(d.mean() / ref.abs().mean())}
        stages.append(stage)
        print(f"frame {worst['frame']} seed {worst['seed']}, {name}: "
              f"{stage['differ']:.4f} of the elements differ; max |Δ| / max |value| "
              f"{stage['max_rel']:.3g}, mean |Δ| / mean |value| {stage['mean_rel']:.3g}",
              flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"gpu": gpu, "settings": SETTINGS,
                                    "frame_points": FRAME_POINTS, "readings": readings,
                                    "stages_of_worst": stages},
                                   indent=2) + "\n")
    print(f"wrote {args.out}", flush=True)
    if any(r["mask_diff_outside_band"] for r in readings):
        raise SystemExit("bf16_card_vs_cpu: masks differ outside the band")


if __name__ == "__main__":
    main()
