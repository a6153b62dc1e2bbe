"""The card against the CPU port in bfloat16, over several frames and seeds:

    python -m recognizer3d_tpu_torch.benchmarks.bf16_card_vs_cpu \
        [--frames 8] [--seeds 2] [--out PATH]

The bundled ``pretrained/mock_fingertip`` weights with ``bench.py``'s
``settings64a`` (``knn="approximate"``, 65,536 points) and
``compute_dtype="bfloat16"`` answer 150,000-point mock frames (numpy seeds
300, 301, ... as in ``chip_smoke.py``) with ``Model.predict`` on the card
and on the CPU, float32 upload, the same sampling seed on both sides. Each
model first answers a warm-up frame, which runs its recall guard (the
session window is process-global, so both sides then search alike).

Every frame × seed is one reading, judged by :func:`logits_agree` on the
network's logits (the forward's output before the softmax and the
upsample), and printed with the class-1 mask's flips and the confidences'
max and mean |Δ| beside it.
The control on the same frame and seed, the card's float32 model against
the CPU's bfloat16 model, must fail the rule: a rule that passed it could
not tell bfloat16 from float32. Then, for the reading with the largest
``max_ulps``, each stage of the network (the outputs of ``RandLANet``'s
child modules, in call order): the share of its elements that differ
between the two sides and its max and mean |Δ| over its max and mean
|value|, which shows where the difference grows. The run fails if any
reading misses the rule or any control meets it. The card's name and power
limit come first; the record goes to ``--out`` as JSON. It runs on the card
and fails without one.
"""

import argparse
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
ARCHIVE = ROOT / "pretrained" / "mock_fingertip"
SETTINGS = dict(knn="approximate", n_points=65_536, compute_dtype="bfloat16")
FRAME_POINTS = 150_000

#: the card against the CPU in bfloat16 (``logits_agree``). Each stage of the
#: network differs between two bfloat16 runs that sum in other orders by one to
#: three bfloat16 ulps of its largest value, on a growing share of its
#: elements (PERF.md §6). Fixed from 24 readings (12 frames x 2 seeds) of the
#: card's bfloat16 kernels before their tensor-core redesign, on an H100 80GB
#: HBM3 at 700 W: the largest |Δ logit| read 2 to 4.5 ulps of the frame's
#: largest |logit| (limit 8), the mean |Δ| 1.6e-4 to 7.5e-4 of the mean
#: |logit| (limit 1.5e-3). The card's float32 model against the CPU's
#: bfloat16 one read 2.3 to 6.1 ulps, which the largest |Δ| cannot tell from
#: bfloat16, and a mean of 2.65e-3 to 3.3e-3, which the mean does.
MAX_ULPS = 8.0
MEAN_REL = 1.5e-3


def _softmax1(logits: np.ndarray) -> np.ndarray:
    """Class-1 confidence of (C, N) logits."""
    e = np.exp(logits - logits.max(axis=0, keepdims=True))
    return e[1] / e.sum(axis=0)


def logits_agree(got, ref):
    """Whether logits ``got`` agree with ``ref`` (both (C, N), one frame) as
    two bfloat16 forwards that sum in other orders do: the largest |Δ| at
    most ``MAX_ULPS`` bfloat16 ulps of the frame's largest |ref| (an ulp of
    x is 2^(⌊log2 x⌋ − 7)), and the mean |Δ| at most ``MEAN_REL`` of the
    mean |ref|. The class-1 mask (confidence > 0.5) can then flip only where
    ``ref``'s margin |l1 − l0| is at most twice the largest |Δ|; the reading
    counts the flips (``flips``) and the largest such margin in ulps
    (``flip_margin_ulps``). Returns (ok, the reading)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape or got.ndim != 2 or not np.isfinite(got).all():
        raise ValueError(f"logits of shape {got.shape} against {ref.shape}, or not finite")
    d = np.abs(got - ref)
    top = float(np.abs(ref).max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0**-133
    flipped = (_softmax1(got) > 0.5) != (_softmax1(ref) > 0.5)
    margin = np.abs(ref[1] - ref[0])
    reading = {
        "max_ulps": float(d.max() / ulp),
        "mean_rel": float(d.mean() / max(float(np.abs(ref).mean()), 1e-30)),
        "max_abs": float(d.max()),
        "largest_logit": top,
        "flips": int(flipped.sum()),
        "flip_margin_ulps": float(margin[flipped].max() / ulp) if flipped.any() else 0.0,
    }
    ok = reading["max_ulps"] <= MAX_ULPS and reading["mean_rel"] <= MEAN_REL
    return ok, reading


def describe(reading: dict) -> str:
    return (f"max |Δ logit| {reading['max_abs']:.4g} = {reading['max_ulps']:.3g} bf16 ulps of "
            f"{reading['largest_logit']:.4g} (limit {MAX_ULPS:g}), mean |Δ| / mean |logit| "
            f"{reading['mean_rel']:.3g} (limit {MEAN_REL:g}); {reading['flips']} class-1 mask "
            f"flips, at margins up to {reading['flip_margin_ulps']:.3g} ulps")


def predict_logits(model, frame, seed: int):
    """``model.predict(frame)`` after ``np.random.seed(seed)``: (confidences
    (C, N_frame), the network's logits (C, n_points)) as float32 numpy."""
    out = []
    hook = model.module.register_forward_hook(
        lambda _m, _i, logits: out.append(logits.detach().float().cpu().numpy()[0])
    )
    try:
        np.random.seed(seed)
        conf = model.predict(frame)
    finally:
        hook.remove()
    return conf, out[-1]


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=8)
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
    card32 = Model.load(ARCHIVE, device="cuda", **dict(SETTINGS, compute_dtype="float32"))
    frames = [_mock_frame(FRAME_POINTS, 300 + f, 0.45 * f) for f in range(args.frames)]
    for model in (card, cpu, card32):
        np.random.seed(99)
        model.predict(frames[0])
    print(f"recall guard: card {card.recall_guard_result}, CPU {cpu.recall_guard_result}; "
          f"session window {port_knn.session_window_points()}, exact fallback "
          f"{port_knn.session_exact_fallback()}", flush=True)
    readings = []
    for f, frame in enumerate(frames):
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            conf_gpu, logits_gpu = predict_logits(card, frame, seed)
            conf_cpu, logits_cpu = predict_logits(cpu, frame, seed)
            _, logits_f32 = predict_logits(card32, frame, seed)
            ok, rule = logits_agree(logits_gpu, logits_cpu)
            control_ok, control = logits_agree(logits_f32, logits_cpu)
            diff = np.abs(conf_gpu - conf_cpu)
            r = {"frame": f, "seed": seed, "ok": ok, **rule,
                 "conf_max": float(diff.max()), "conf_mean": float(diff.mean()),
                 "control_ok": control_ok, "control": control}
            readings.append(r)
            print(f"frame {f} seed {seed}: {'meets' if ok else 'MISSES'} the rule: "
                  f"{describe(rule)}; confidences max |Δ| {r['conf_max']:.4g}, mean "
                  f"{r['conf_mean']:.3g}; control (card float32): "
                  f"{'MEETS' if control_ok else 'fails'} it: {describe(control)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for key in ("max_ulps", "mean_rel", "conf_max"):
        values = [r[key] for r in readings]
        print(f"{key} over {len(values)} readings: largest {max(values):.4g}, median "
              f"{statistics.median(values):.4g}, smallest {min(values):.4g}; the controls' "
              f"smallest {min(r['control'].get(key, math.inf) for r in readings):.4g}",
              flush=True)
    worst = max(readings, key=lambda r: r["max_ulps"])
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
                                    "frame_points": FRAME_POINTS,
                                    "rule": {"max_ulps": MAX_ULPS, "mean_rel": MEAN_REL},
                                    "readings": readings, "stages_of_worst": stages},
                                   indent=2) + "\n")
    print(f"wrote {args.out}", flush=True)
    missed = [(r["frame"], r["seed"]) for r in readings if not r["ok"]]
    passed = [(r["frame"], r["seed"]) for r in readings if r["control_ok"]]
    if missed or passed:
        raise SystemExit(f"bf16_card_vs_cpu: readings that miss the rule {missed}; controls "
                         f"that meet it {passed}")


if __name__ == "__main__":
    main()
