"""Reference PyTorch archives (the port's own copy of
``recognizer3d_tpu/models/torch_compat.py``).

The reference implementation saves a zip of a ``config`` JSON and a
``model`` blob that is a ``torch.save`` of its RandLA-Net ``state_dict``
(key names like ``encoder.0.mlp1.conv.weight``), optionally under a
``"model"`` key. ``Model.load`` reads such archives: the state_dict is
mapped into the flax-layout numpy tree (``{"params", "batch_stats"}``) and
from there into this package's modules (``models/weights.py``).

Mapping rules:

- torch ``Conv2d`` / ``ConvTranspose2d`` 1×1 weights (out, in, 1, 1) /
  (in, out, 1, 1) -> Dense kernels (in, out);
- torch ``Linear`` weights (out, in) -> Dense kernels (in, out);
- BatchNorm ``weight`` / ``bias`` -> scale / bias params;
  ``running_mean`` / ``running_var`` -> batch_stats.
"""

import io
import json
import os
import shutil
import tempfile
from dataclasses import asdict
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from recognizer3d_tpu_torch.models.settings import RandLANetSettings


def state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    """Detach a torch state_dict to plain numpy arrays."""
    out = {}
    for k, v in state_dict.items():
        out[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
    return out


def _dense_from_torch(weight: np.ndarray, transpose_conv: bool = False):
    """torch conv/linear weight -> flax Dense kernel (in, out)."""
    w = np.asarray(weight, dtype=np.float32)
    if w.ndim == 4:  # (out, in, 1, 1) conv or (in, out, 1, 1) transpose conv
        w = w[..., 0, 0]
        if not transpose_conv:
            w = w.T
    else:  # linear (out, in)
        w = w.T
    return w


def _shared_mlp(sd, prefix: str, transpose_conv: bool = False, bn: bool = True):
    """flax param / batch_stats dicts for one SharedMLP."""
    params = {
        "conv": {
            "kernel": _dense_from_torch(sd[f"{prefix}.conv.weight"], transpose_conv),
            "bias": np.asarray(sd[f"{prefix}.conv.bias"], dtype=np.float32),
        }
    }
    stats = {}
    if bn:
        params["batch_norm"] = {
            "scale": np.asarray(sd[f"{prefix}.batch_norm.weight"], dtype=np.float32),
            "bias": np.asarray(sd[f"{prefix}.batch_norm.bias"], dtype=np.float32),
        }
        stats["batch_norm"] = {
            "mean": np.asarray(sd[f"{prefix}.batch_norm.running_mean"], dtype=np.float32),
            "var": np.asarray(sd[f"{prefix}.batch_norm.running_var"], dtype=np.float32),
        }
    return params, stats


def _attentive_pooling(sd, prefix: str):
    mlp_p, mlp_s = _shared_mlp(sd, f"{prefix}.mlp")
    params = {
        "score_fn": {"kernel": _dense_from_torch(sd[f"{prefix}.score_fn.0.weight"])},
        "mlp": mlp_p,
    }
    return params, {"mlp": mlp_s}


def torch_state_dict_to_variables(
    sd: Dict[str, np.ndarray], settings: RandLANetSettings
) -> Dict:
    """Reference state_dict (numpy values) -> flax-layout variables."""
    params: Dict = {}
    stats: Dict = {}

    params["fc_start"] = {
        "kernel": _dense_from_torch(sd["fc_start.weight"]),
        "bias": np.asarray(sd["fc_start.bias"], dtype=np.float32),
    }
    params["bn_start"] = {
        "scale": np.asarray(sd["bn_start.0.weight"], dtype=np.float32),
        "bias": np.asarray(sd["bn_start.0.bias"], dtype=np.float32),
    }
    stats["bn_start"] = {
        "mean": np.asarray(sd["bn_start.0.running_mean"], dtype=np.float32),
        "var": np.asarray(sd["bn_start.0.running_var"], dtype=np.float32),
    }

    for i in range(len(settings.layer_sizes)):
        enc_p: Dict = {}
        enc_s: Dict = {}
        for mlp_name in ["mlp1", "mlp2", "shortcut", "mlp_rpe1", "mlp_rpe2"]:
            p, st = _shared_mlp(sd, f"encoder.{i}.{mlp_name}")
            enc_p[mlp_name] = p
            enc_s[mlp_name] = st
        for pool_name in ["pool1", "pool2"]:
            p, st = _attentive_pooling(sd, f"encoder.{i}.{pool_name}")
            enc_p[pool_name] = p
            enc_s[pool_name] = st
        params[f"encoder_{i}"] = enc_p
        stats[f"encoder_{i}"] = enc_s

    p, st = _shared_mlp(sd, "mlp")
    params["mlp"] = p
    stats["mlp"] = st

    for i in range(len(settings.layer_sizes)):
        p, st = _shared_mlp(sd, f"decoder.{i}", transpose_conv=True)
        params[f"decoder_{i}"] = p
        stats[f"decoder_{i}"] = st

    # fc_end: Sequential(SharedMLP, SharedMLP, Dropout, SharedMLP(bn=False))
    for flax_name, torch_idx, bn in [
        ("fc_end_0", 0, True),
        ("fc_end_1", 1, True),
        ("fc_end_2", 3, False),
    ]:
        p, st = _shared_mlp(sd, f"fc_end.{torch_idx}", bn=bn)
        params[flax_name] = p
        if bn:
            stats[flax_name] = st

    return {"params": params, "batch_stats": stats}


def variables_to_torch_state_dict(
    variables: Dict, settings: RandLANetSettings
) -> Dict[str, np.ndarray]:
    """Inverse conversion: flax-layout variables -> reference-named numpy
    state_dict (conv weights re-expanded to (out, in, 1, 1) / (in, out, 1, 1))."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def put_dense(torch_key: str, p: Dict, conv: bool, transpose: bool = False):
        w = np.asarray(p["kernel"])
        if conv:
            w = w if transpose else w.T
            w = w[..., None, None]  # (·, ·, 1, 1)
        else:
            w = w.T
        sd[f"{torch_key}.weight"] = w
        if "bias" in p:
            sd[f"{torch_key}.bias"] = np.asarray(p["bias"])

    def put_bn(torch_key: str, p: Dict, st: Dict):
        sd[f"{torch_key}.weight"] = np.asarray(p["scale"])
        sd[f"{torch_key}.bias"] = np.asarray(p["bias"])
        sd[f"{torch_key}.running_mean"] = np.asarray(st["mean"])
        sd[f"{torch_key}.running_var"] = np.asarray(st["var"])
        sd[f"{torch_key}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    def put_shared_mlp(torch_prefix: str, p: Dict, st: Dict, transpose=False):
        put_dense(f"{torch_prefix}.conv", p["conv"], conv=True, transpose=transpose)
        if "batch_norm" in p:
            put_bn(f"{torch_prefix}.batch_norm", p["batch_norm"], st["batch_norm"])

    put_dense("fc_start", params["fc_start"], conv=False)
    put_bn("bn_start.0", params["bn_start"], stats["bn_start"])

    for i in range(len(settings.layer_sizes)):
        ep, es = params[f"encoder_{i}"], stats[f"encoder_{i}"]
        for mlp_name in ["mlp1", "mlp2", "shortcut", "mlp_rpe1", "mlp_rpe2"]:
            put_shared_mlp(f"encoder.{i}.{mlp_name}", ep[mlp_name], es[mlp_name])
        for pool_name in ["pool1", "pool2"]:
            put_dense(
                f"encoder.{i}.{pool_name}.score_fn.0",
                ep[pool_name]["score_fn"],
                conv=False,
            )
            put_shared_mlp(
                f"encoder.{i}.{pool_name}.mlp",
                ep[pool_name]["mlp"],
                es[pool_name]["mlp"],
            )

    put_shared_mlp("mlp", params["mlp"], stats["mlp"])
    for i in range(len(settings.layer_sizes)):
        put_shared_mlp(
            f"decoder.{i}", params[f"decoder_{i}"], stats[f"decoder_{i}"],
            transpose=True,
        )
    put_shared_mlp("fc_end.0", params["fc_end_0"], stats["fc_end_0"])
    put_shared_mlp("fc_end.1", params["fc_end_1"], stats["fc_end_1"])
    put_shared_mlp("fc_end.3", params["fc_end_2"], {})
    return sd


def load_reference_weights(blob: bytes, settings: RandLANetSettings) -> Dict:
    """A reference archive's ``model`` blob -> flax-layout variables. The
    blob is read with ``weights_only=True``: tensors and containers only."""
    state_dict = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    if "model" in state_dict.keys():
        state_dict = state_dict["model"]
    return torch_state_dict_to_variables(state_dict_to_numpy(state_dict), settings)


def save_reference_archive(
    path: Path, settings: RandLANetSettings, state_dict: Dict[str, np.ndarray]
) -> None:
    """Write a reference-layout archive: a zip of ``config`` (JSON) and
    ``model`` (``torch.save`` of ``{"model": state_dict}`` as tensors)."""
    path = Path(path)
    os.makedirs(path.parent, exist_ok=True)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}
    with tempfile.TemporaryDirectory() as tmp_str:
        tmp = Path(tmp_str)
        with (tmp / "config").open("w") as f:
            json.dump(asdict(settings), f)
        buf = io.BytesIO()
        torch.save({"model": tensors}, buf)
        (tmp / "model").write_bytes(buf.getvalue())
        with tempfile.TemporaryDirectory() as tmp2:
            shutil.make_archive(str(Path(tmp2) / "file"), "zip", tmp)
            shutil.move(str(Path(tmp2) / "file.zip"), path)
