"""The training outcome on the GPU, against the reference trainer's and the
TPU trainer's (the recipe of ``benchmarks/compare_training_parity.py``):

    python -m recognizer3d_tpu_torch.benchmarks.training_parity [--out PATH]

Recipe: 30 clouds of 20,000 points from ``bin/make_mock_data 30 20000
<dir> --annotate`` (written under ``build/parity30``), broadened
annotations, merged and split 80/20 under numpy seed 3 (24 / 6); the app's
model config (``knn="naive"``, 2,500 points, K = 32, decimation 4); 20
epochs, batch 4, lr 1e-2 with StepLR(10, 0.9), dice, no early stopping, the
app's augmentation, batches assembled on the card; the 10-seed validation
each epoch; at the end ``Model.evaluate(val, batch_size=4,
include_stdev=True)``. numpy is seeded 0 before the run, as in the other
two sides' runs.

It prints the loss and val_mIoU of every epoch, the final val mIoU ± σ
beside ``benchmarks/training_parity_reference.json`` (the reference
PyTorch trainer on one CPU core) and ``benchmarks/training_parity_tpu.json``
(the JAX trainer on a TPU v5e), and the verdict of the comparison's
criterion: the gap to the reference's mean below σ_ref + σ_port. The whole
record goes to ``--out`` as JSON. The card's name and power limit come
first. It runs on the card and fails without one.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
DATASET = ROOT / "build" / "parity30"
REFERENCE = ROOT / "benchmarks" / "training_parity_reference.json"
TPU = ROOT / "benchmarks" / "training_parity_tpu.json"
CLASS_NAMES = ["background", "fingerpoint"]
EPOCHS = 20
BATCH = 4


def _gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def _band(record):
    miou = record["final_eval"]["mIoU"]
    return float(miou[0]), float(miou[1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "training_parity_port.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("training_parity: torch.cuda.is_available() is False")
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch.data.dataset import Dataset, DatasetMerged
    from recognizer3d_tpu_torch.train import app_augmentation, app_model_config
    from recognizer3d_tpu_torch.training.settings import TrainingSettings

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    if not DATASET.is_dir():
        subprocess.run([sys.executable, str(ROOT / "bin" / "make_mock_data"), "30", "20000",
                        str(DATASET), "--annotate"], check=True, timeout=600)
    np.random.seed(0)
    train_ds, val_ds = DatasetMerged([Dataset(DATASET, broaden_annotations=True)]).split()
    print(f"train {len(train_ds)} / val {len(val_ds)}", flush=True)
    model = Model(app_model_config())
    training = TrainingSettings(epochs=EPOCHS, batch_size=BATCH, learning_rate=1e-2,
                                early_stopping=False, device_pipeline=True)
    epochs = []

    def callback(epoch, metrics):
        rec = {k: float(v) for k, v in metrics.items()}
        rec["epoch"] = epoch
        epochs.append(rec)
        print(f"epoch {epoch}: loss {rec['loss']:.4f} val_loss {rec['val_loss']:.4f} "
              f"val_mIoU {rec['val_mIoU']:.4f}", flush=True)

    t0 = time.perf_counter()
    trainer = model.train(train_ds, val_ds, training, app_augmentation(), None, CLASS_NAMES,
                          callbacks=[callback])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    final = model.evaluate(val_ds, CLASS_NAMES, batch_size=BATCH, include_stdev=True)
    final = {k: list(v) for k, v in final.items()}
    port = {"side": "port", "gpu": gpu, "wall_sec": wall, "epochs": epochs,
            "epoch_sec": [[h["train_s"], h["validate_s"]] for h in trainer.history],
            "final_eval": final}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(port, indent=2) + "\n")

    m_port, s_port = _band(port)
    print(f"\nfinal val mIoU ± σ (10 seeds), fingerpoint IoU ± σ, wall of Model.train:")
    for name, path in (("reference (torch, 1 CPU core)", REFERENCE), ("TPU (JAX, v5e)", TPU)):
        rec = json.loads(path.read_text())
        m, s = _band(rec)
        fp = rec["final_eval"]["fingerpoint IoU"]
        print(f"  {name:32s} {m:.4f} ± {s:.4f}, {fp[0]:.4f} ± {fp[1]:.4f}, "
              f"{rec['wall_sec']:.1f} s", flush=True)
    fp = final["fingerpoint IoU"]
    print(f"  {'port (this run)':32s} {m_port:.4f} ± {s_port:.4f}, {fp[0]:.4f} ± {fp[1]:.4f}, "
          f"{wall:.1f} s", flush=True)
    m_ref, s_ref = _band(json.loads(REFERENCE.read_text()))
    gap = abs(m_ref - m_port)
    verdict = "met" if gap < s_ref + s_port else "missed"
    print(f"criterion: |mIoU_ref - mIoU_port| = {gap:.4f} against σ_ref + σ_port = "
          f"{s_ref + s_port:.4f}: {verdict}", flush=True)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
