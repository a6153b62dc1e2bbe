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

The model runs on the card unless ``--device cpu`` is given.
``--devices N`` shards each batch over N ranks, one process and one card
each (``parallel/serving.DPServing``); ``--point-shards N`` instead shards
each cloud's points over N ranks (``SPServing``): the full-resolution
forward, every point classified by the network with no subsample and
upsample, for clouds beyond one card. On the card N is at most the visible
cards and -1 means all of them; with ``--device cpu`` any N runs that many
ranks on the CPU (-1: one). The two flags exclude each other.

Usage:
    python -m recognizer3d_tpu_torch.serve -m models/<ts> -d data/captures -o out/
        [--batch 8] [--threshold 0.5] [--confidences] [--transfer-dtype float16]
        [--device cuda] [--devices N | --point-shards N]
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
                    help="shard each batch over this many ranks, a card each (-1: all "
                    "cards); 1 serves on one card")
    ap.add_argument("--point-shards", type=int, default=1,
                    help="shard each cloud's points over this many ranks (-1: all cards): "
                    "the full-resolution forward by the ring KNN, for clouds beyond one "
                    "card; excludes --devices")
    ap.add_argument(
        "--transfer-dtype", choices=("float32", "float16"), default="float16",
        help="upload dtype of full clouds (default float16: half the host-to-device "
        "bytes; quantization below the sensor's noise). float32 for exact parity runs",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the GPU)")
    args = ap.parse_args(argv)
    if args.devices != 1 and args.point_shards != 1:
        ap.error("--devices and --point-shards are mutually exclusive")
    ranks = args.devices if args.devices != 1 else args.point_shards
    devices = None
    if ranks != 1:
        from recognizer3d_tpu_torch.parallel.mesh import devices_for

        try:
            devices = devices_for(ranks, args.device)
        except ValueError as exc:
            ap.error(f"{'--devices' if args.devices != 1 else '--point-shards'}: {exc}")

    from recognizer3d_tpu_torch.models.facade import Model

    model = Model.load(args.model, device=devices[0] if devices else args.device,
                       transfer_dtype=args.transfer_dtype)
    if devices is None:
        summary = _serve(args, model)
    else:
        from recognizer3d_tpu_torch.parallel.serving import DPServing, SPServing

        # the workers are joined before the summary line is printed
        dp = args.devices != 1
        with (DPServing if dp else SPServing)(model, devices) as server:
            summary = _serve(args, server, *((len(devices), 1) if dp else (1, len(devices))))
    print(json.dumps(summary))
    return 0


def _serve(args, model, devices: int = 1, point_shards: int = 1) -> dict:
    """Warm up, serve every batch and return the throughput summary;
    ``model`` is a ``Model`` or a server of ``devices`` or ``point_shards``
    ranks."""
    from recognizer3d_tpu_torch.models.facade import _bucket

    args.out.mkdir(parents=True, exist_ok=True)

    def predict_once(clouds):
        if args.confidences:
            return model.predict(clouds), "_confidences.npy"
        return model.predict_mask(clouds, args.threshold), "_prediction.npy"

    shapes = distinct_batch_shapes(args.dataset, args.batch)
    if not shapes:
        return {"clouds": 0, "seconds": 0.0}
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
    return {
        "clouds": n_clouds,
        "seconds": round(dt, 3),
        "clouds_per_sec": round(n_clouds / dt, 3) if dt else None,
        "batch": args.batch,
        "devices": devices,
        "point_shards": point_shards,
        "output": "confidences" if args.confidences else "mask",
    }


if __name__ == "__main__":
    sys.exit(main())
