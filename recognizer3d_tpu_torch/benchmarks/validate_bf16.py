"""The bfloat16 accuracy gate's evaluation half on the GPU (the port's
counterpart of ``benchmarks/validate_bf16.py``, part 2):

    python -m recognizer3d_tpu_torch.benchmarks.validate_bf16 [--out PATH]

The bundled ``pretrained/mock_fingertip`` weights at the app config are
evaluated on the validation split of ``data/mock100`` (100 clouds of 60,000
points from ``bin/make_mock_data 100 60000 data/mock100 --annotate``, made
here if missing; broadened annotations, split 80/20 under numpy seed 3, so
20 clouds) with the 10-seed protocol (``Model.evaluate(val, batch_size=16,
include_stdev=True)``), once with ``compute_dtype="float32"`` and once with
``"bfloat16"``. It prints both mIoU ± σ, their difference, and the JAX
package's result on a TPU (``benchmarks/bf16_validation.json``) beside them
as the reference's outcome. The record goes to ``--out`` as JSON. The
card's name and power limit come first. It runs on the card and fails
without one.

The gate's other half, the float32-against-bfloat16 mask IoU on the
reference's real L515 captures, waits for those captures to be in the
repository.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARCHIVE = ROOT / "pretrained" / "mock_fingertip"
DATASET = ROOT / "data" / "mock100"
TPU = ROOT / "benchmarks" / "bf16_validation.json"
CLASS_NAMES = ["background", "fingerpoint"]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "bf16_validation_port.json")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("validate_bf16: torch.cuda.is_available() is False")
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch.benchmarks.training_parity import _gpu_line
    from recognizer3d_tpu_torch.data.dataset import Dataset

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    if not DATASET.is_dir():
        subprocess.run([sys.executable, str(ROOT / "bin" / "make_mock_data"), "100", "60000",
                        str(DATASET), "--annotate"], check=True, timeout=600)
    _, val = Dataset(DATASET, broaden_annotations=True).split()
    evals = {}
    for dtype in ("float32", "bfloat16"):
        model = Model.load(ARCHIVE, compute_dtype=dtype)
        metrics = model.evaluate(val, CLASS_NAMES, batch_size=16, include_stdev=True)
        evals[dtype] = {k: [float(x) for x in v] for k, v in metrics.items()}
        miou = evals[dtype]["mIoU"]
        print(f"{dtype}: mIoU {miou[0]:.5f} ± {miou[1]:.5f} over {len(val)} clouds", flush=True)
    delta = evals["float32"]["mIoU"][0] - evals["bfloat16"]["mIoU"][0]
    tpu = json.loads(TPU.read_text())["mock100_eval_10seed"]
    print(f"mIoU float32 - bfloat16: {delta:.5f} (the JAX package on a TPU, quoted from "
          f"{TPU.relative_to(ROOT)}: {tpu['float32']['mIoU'][0]:.5f} and "
          f"{tpu['bfloat16']['mIoU'][0]:.5f})", flush=True)
    record = {"gpu": gpu, "n_val": len(val), "mock100_eval_10seed": evals,
              "mock100_mIoU_delta": delta}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=2) + "\n")
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
