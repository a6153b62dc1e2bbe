"""Batch-serving CLI of the port (counterpart of the repository's
``serve.py``): segment every cloud of a capture directory on one card.

Load a trained model once, stream every cloud of the directory through the
card in batches, and write one output a cloud next to a throughput summary
(one JSON line on stdout, the JAX CLI's). Clouds are batched by point count,
so each batch has one shape (the facade pads each to its bucket; eval
batches past 131,072 points in all run one cloud at a time). The default
output is the class-1 foreground mask (``<ts>_prediction.npy``, bool,
thresholded on the card); ``--confidences`` writes the (C, N) float
confidences (``<ts>_confidences.npy``) instead. One synthetic batch per
distinct (batch size, bucket) warms the kernels and the allocator before
the clock starts.

The model runs on the card unless ``--device cpu`` is given. Serving over
several cards (``--devices``) or a cloud's points sharded over cards
(``--point-shards``) is ROADMAP A9, not ported: any value other than 1
is refused.

Usage:
    python -m recognizer3d_tpu_torch.serve -m models/<ts> -d data/captures -o out/
        [--batch 8] [--threshold 0.5] [--confidences] [--transfer-dtype float16]
        [--device cuda]
"""

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np


def distinct_batch_shapes(root: Path, batch_size: int):
    """The set of (B, N) batch shapes :func:`iter_batches` will yield, from
    the shapes of the memory-mapped files alone (no cloud data loaded)."""
    groups = defaultdict(int)
    for f in sorted(Path(root).glob("*_data.npy")):
        groups[np.load(f, mmap_mode="r").shape[0]] += 1
    shapes = set()
    for n, count in groups.items():
        if count >= batch_size:
            shapes.add((batch_size, n))
        if count % batch_size:
            shapes.add((count % batch_size, n))
    return shapes


def iter_batches(root: Path, batch_size: int):
    """Yield (stems, stacked clouds (B, N, 3) float32) grouped by point
    count; a batch's clouds load when it is reached."""
    groups = defaultdict(list)
    for f in sorted(Path(root).glob("*_data.npy")):
        groups[np.load(f, mmap_mode="r").shape[0]].append(f)
    for _n, files in sorted(groups.items()):
        for lo in range(0, len(files), batch_size):
            chunk = files[lo : lo + batch_size]
            yield (
                [f.name[: -len("_data.npy")] for f in chunk],
                np.stack([np.load(f).astype(np.float32) for f in chunk]),
            )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", type=Path, required=True)
    ap.add_argument("-d", "--dataset", type=Path, required=True,
                    help="capture directory (<ts>_data.npy files)")
    ap.add_argument("-o", "--out", type=Path, required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--confidences", action="store_true",
                    help="write (C, N) float confidences instead of the bool mask")
    ap.add_argument("--devices", type=int, default=1,
                    help="cards to shard each batch over; only 1 (ROADMAP A9)")
    ap.add_argument("--point-shards", type=int, default=1,
                    help="cards to shard each cloud's points over; only 1 (ROADMAP A9)")
    ap.add_argument(
        "--transfer-dtype", choices=("float32", "float16"), default="float16",
        help="upload dtype of full clouds (default float16: half the host-to-device "
        "bytes; quantization below the sensor's noise). float32 for exact parity runs",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the GPU)")
    args = ap.parse_args(argv)
    for flag, value in (("--devices", args.devices), ("--point-shards", args.point_shards)):
        if value != 1:
            ap.error(f"{flag} {value}: serving over more than one card is not ported yet "
                     "(ROADMAP A9); this CLI serves on one card")

    from recognizer3d_tpu_torch.models.facade import Model, _bucket

    model = Model.load(args.model, device=args.device, transfer_dtype=args.transfer_dtype)
    args.out.mkdir(parents=True, exist_ok=True)

    def predict_once(clouds):
        if args.confidences:
            return model.predict(clouds), "_confidences.npy"
        return model.predict_mask(clouds, args.threshold), "_prediction.npy"

    shapes = distinct_batch_shapes(args.dataset, args.batch)
    if not shapes:
        print(json.dumps({"clouds": 0, "seconds": 0.0}))
        return 0
    # one synthetic batch per (B, bucket): the shapes the card sees
    warm_rng = np.random.RandomState(0)
    warmed = set()
    for b, n in sorted(shapes):
        if (b, _bucket(n)) not in warmed:
            warmed.add((b, _bucket(n)))
            predict_once(warm_rng.rand(b, n, 3).astype(np.float32))

    n_clouds = 0
    t0 = time.perf_counter()
    for stamps, clouds in iter_batches(args.dataset, args.batch):
        out, suffix = predict_once(clouds)
        for stem, row in zip(stamps, out):
            np.save(args.out / f"{stem}{suffix}", row)
        n_clouds += len(stamps)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "clouds": n_clouds,
        "seconds": round(dt, 3),
        "clouds_per_sec": round(n_clouds / dt, 3) if dt else None,
        "batch": args.batch,
        "devices": args.devices,
        "point_shards": args.point_shards,
        "output": "confidences" if args.confidences else "mask",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
