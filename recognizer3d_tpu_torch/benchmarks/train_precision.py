"""How far one float32 train step at the app config lies from the same step
in float64, on the card and on the CPU, and which operations make the
difference:

    python -m recognizer3d_tpu_torch.benchmarks.train_precision [--batches 6] [--out PATH]

Data: ``bin/make_mock_data 12 20000 build/precision12 --annotate``,
broadened annotations, batches of 4 × 2,500 points assembled on the card
with the app's augmentation, each with its own permutation and keep mask
(a ``torch.Generator`` seeded 0). Weights: the app config's seed-0 init
after 6 float32 Adam steps on the card at lr 1e-2, as many as
``chip_smoke.py``'s 2-epoch run takes.

For each batch, one step from the same weights, batch, permutation and
mask: on the CPU in float64 (the module in double; geometry and the
neighbour search stay float32), the reference; on the CPU and on the card
in float32; and on the card in float32 with TF32 allowed for matmuls, the
control. Each float32 step's distance is :func:`grad_distance`: the
largest and the median over the tensors.

On the first batch, where the distance comes from, each operation alone on
the reference step's own inputs rounded to float32, in float32 on each
device against float64 from the same rounded inputs:

- every train-mode BatchNorm's statistics: the batch mean (in units of the
  batch standard deviation) and the fast variance E[x²] − E[x]² (relative
  to the variance), the largest over channels;
- every Dense's weight gradient dYᵀ·X (relative to its largest entry);
- every BatchNorm's output in the whole float32 forward (relative to its
  largest value), which carries what the layers before it rounded.

It prints one line per batch and the five worst layers of each kind, and
writes the whole record to ``--out`` as JSON. The card's name and power
limit come first. It runs on the card and fails without one.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict

import torch

from recognizer3d_tpu_torch.models.randlanet import BatchNorm, bn_absorbed_biases

ROOT = Path(__file__).resolve().parents[2]
DATASET = ROOT / "build" / "precision12"
WARM_STEPS = 6


def grad_distances(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]):
    """Per tensor, max |g − ref| over the largest |ref| of the tensor, or
    for a Dense bias before a BatchNorm (exact gradient 0) over that of its
    weight (``bn_absorbed_biases``)."""
    absorbed = bn_absorbed_biases(ref)
    return {
        name: float((grads[name].double() - r.double()).abs().max())
        / float(ref[absorbed.get(name, name)].abs().max())
        for name, r in ref.items()
    }


def grad_distance(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]):
    """``(max, median, tensor of the max)`` of :func:`grad_distances`."""
    d = grad_distances(grads, ref)
    worst = max(d, key=d.get)
    return d[worst], statistics.median(d.values()), worst


def step_gradients(settings, weights, batch, device, dtype=torch.float32, tf32=False,
                   bn_outputs=None, captures=None):
    """One train step's gradients ``{name: float64 CPU tensor}`` from
    ``weights``; ``batch`` = (inputs, labels, permutation, keep mask).
    ``bn_outputs`` (a dict) receives each BatchNorm's output, ``captures``
    each BatchNorm's input and each Dense's input and output gradient."""
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch.training import losses

    module = Model(settings, weights=weights, device=device).module.to(dtype)
    module.train()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32  # the model has set it off
    handles = []
    for name, mod in module.named_modules():
        if isinstance(mod, BatchNorm):
            if bn_outputs is not None:
                handles.append(mod.register_forward_hook(
                    lambda m, i, o, _n=name: bn_outputs.__setitem__(_n, o.detach().cpu())))
            if captures is not None:
                handles.append(mod.register_forward_pre_hook(
                    lambda m, i, _n=name: captures.__setitem__(("bn", _n), i[0].detach().cpu())))
        elif isinstance(mod, torch.nn.Linear) and captures is not None:
            def dense_hook(m, i, o, _n=name):
                captures[("x", _n)] = i[0].detach().cpu()
                o.register_hook(lambda g: captures.__setitem__(("dy", _n), g.detach().cpu()))
            handles.append(mod.register_forward_hook(dense_hook))
    try:
        inputs, labels, perm, keep = (t.to(device) for t in batch)
        logits = module(inputs.to(dtype), perm, keep)
        losses.get_loss("dice")(logits, labels).backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
        for h in handles:
            h.remove()
    return {n: p.grad.detach().cpu().double() for n, p in module.named_parameters()}


def bn_statistics_errors(captures, device):
    """Per BatchNorm: (mean error in batch standard deviations, variance
    error relative to the variance), the largest over channels, of float32
    statistics on ``device`` against float64 from the same float32 input."""
    out = {}
    for (kind, name), x in captures.items():
        if kind != "bn":
            continue
        x32 = x.float()
        axes = tuple(range(x32.dim() - 1))
        ref_mean = x32.double().mean(axes)
        ref_var = (x32.double() ** 2).mean(axes) - ref_mean ** 2
        xd = x32.to(device)
        mean = xd.mean(axes)
        var = torch.clamp((xd * xd).mean(axes) - mean * mean, min=0.0)
        std = ref_var.clamp(min=1e-30).sqrt()
        out[name] = (float(((mean.cpu().double() - ref_mean).abs() / std).max()),
                     float(((var.cpu().double() - ref_var).abs() / ref_var.clamp(min=1e-30)).max()))
    return out


def dense_grad_errors(captures, device):
    """Per Dense: max |dYᵀ·X (float32 on ``device``) − float64| over its
    largest |entry|, from the same float32 inputs."""
    out = {}
    for (kind, name), x in captures.items():
        if kind != "x" or ("dy", name) not in captures:
            continue
        x32 = x.float().reshape(-1, x.shape[-1])
        dy32 = captures["dy", name].float().reshape(-1, captures["dy", name].shape[-1])
        ref = dy32.double().t() @ x32.double()
        got = (dy32.to(device).t() @ x32.to(device)).cpu().double()
        out[name] = float((got - ref).abs().max() / ref.abs().max())
    return out


def _worst(table, key=lambda v: v, n=5):
    return sorted(table.items(), key=lambda kv: -key(kv[1]))[:n]


def _gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=6)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "train_precision.json")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("train_precision: torch.cuda.is_available() is False")
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch.data.dataset import Dataset
    from recognizer3d_tpu_torch.data.pipeline import DeviceDatasetCache
    from recognizer3d_tpu_torch.train import app_augmentation, app_model_config
    from recognizer3d_tpu_torch.training import losses
    from recognizer3d_tpu_torch.training.trainer import dropout_mask, make_optimizer, train_step

    print(f"gpu: {_gpu_line()}", flush=True)
    if not DATASET.is_dir():
        subprocess.run([sys.executable, str(ROOT / "bin" / "make_mock_data"), "12", "20000",
                        str(DATASET), "--annotate"], check=True, timeout=600)
    ds = Dataset(DATASET, broaden_annotations=True)
    settings = app_model_config()
    cache = DeviceDatasetCache([ds[i] for i in range(len(ds))], settings.n_points,
                               augmentation_settings=app_augmentation(), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def batch():
        ids = torch.randperm(cache.n_samples, generator=gen, device="cuda")[:4]
        inputs, labels = cache.sample_batch(ids, gen)
        perm = torch.randperm(inputs.shape[1], generator=gen, device="cuda")
        return inputs, labels, perm, dropout_mask(gen, inputs)

    model = Model(settings, device="cuda")
    opt = make_optimizer(model.module, 1e-2)
    model.module.train()
    criterion = losses.get_loss("dice")
    for _ in range(WARM_STEPS):
        train_step(model.module, opt, criterion, *batch())
    weights = {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}

    record = {"batches": [], "first_batch": {}}
    for b in range(args.batches):
        data = tuple(t.cpu() for t in batch())
        first = b == 0
        captures, bn64, bn_cpu, bn_card = {}, {}, {}, {}
        exact = step_gradients(settings, weights, data, "cpu", torch.float64,
                               bn_outputs=bn64 if first else None,
                               captures=captures if first else None)
        runs = {
            "cpu": step_gradients(settings, weights, data, "cpu",
                                  bn_outputs=bn_cpu if first else None),
            "card": step_gradients(settings, weights, data, "cuda",
                                   bn_outputs=bn_card if first else None),
            "card_tf32": step_gradients(settings, weights, data, "cuda", tf32=True),
        }
        row = {k: grad_distance(g, exact) for k, g in runs.items()}
        record["batches"].append({k: grad_distances(g, exact) for k, g in runs.items()})
        print(f"batch {b}: distance from the float64 step (of max |g|), max over the tensors "
              f"(at) / median: " + ", ".join(f"{k} {d:.3g} ({n}) / {med:.3g}"
                                             for k, (d, med, n) in row.items()), flush=True)
        if not first:
            continue
        for device in ("cpu", "cuda"):
            stats = bn_statistics_errors(captures, device)
            dense = dense_grad_errors(captures, device)
            record["first_batch"][device] = {"bn_statistics": stats, "dense_grad": dense}
        for name, table in (("cpu", bn_cpu), ("card", bn_card)):
            record["first_batch"].setdefault("bn_output", {})[name] = {
                k: float((v.double() - bn64[k]).abs().max() / bn64[k].abs().max())
                for k, v in table.items()
            }
        del captures
    fb = record["first_batch"]
    for device in ("cpu", "cuda"):
        print(f"first batch, {device}: BatchNorm variance, worst 5 (mean err in std, var rel "
              f"err): " + "; ".join(f"{k} {m:.3g} / {v:.3g}" for k, (m, v) in
                                    _worst(fb[device]["bn_statistics"], key=lambda t: t[1])),
              flush=True)
        print(f"first batch, {device}: Dense weight gradient dY^T X, worst 5: "
              + "; ".join(f"{k} {e:.3g}" for k, e in _worst(fb[device]["dense_grad"])),
              flush=True)
    for name in ("cpu", "card"):
        print(f"first batch, {name}: BatchNorm output in the float32 forward, worst 5: "
              + "; ".join(f"{k} {e:.3g}" for k, e in _worst(fb["bn_output"][name])), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
