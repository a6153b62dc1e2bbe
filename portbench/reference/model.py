"""RandLA-Net's eval forward (Hu et al., arXiv:1911.11236) in plain PyTorch,
float32, one cloud at a time, written from the architecture: no kernel, no
cache, no batching, nothing of the measured package.

- Random sampling is an explicit permutation: encoder level i keeps the
  first N / decimation^i points of the permuted cloud.
- Each encoder level is one local feature aggregation (LFA) block: an exact
  k-nearest-neighbour search, the LocSE encoding ``[centre, neighbour,
  centre − neighbour, distance]`` through a Dense, BatchNorm and ReLU,
  attentive pooling, a second round over the pooled features, and the
  residual ``lrelu_0.01(mlp2(f) + shortcut(input))``.
- The decoder copies each coarse point's features to the finer points whose
  nearest it is, and concatenates the encoder's features of that level.
- BatchNorm is eval mode, ``(x − mean) · weight / sqrt(var + 1e-6) + bias``.

Each LFA block runs in chunks of query rows, so that the (rows, K, C)
neighbour tensors of a million-point level fit.
"""

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.knn import knn

BN_EPS = 1e-6
CHUNK = 65536


def _bn(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + BN_EPS)
    return (x - p[f"{name}.running_mean"]) * scale + p[f"{name}.bias"]


def _mlp(p, name: str, x: torch.Tensor, act=None, bn: bool = True) -> torch.Tensor:
    x = F.linear(x, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"])
    if bn:
        x = _bn(p, f"{name}.batch_norm", x)
    if act == "relu":
        return torch.relu(x)
    if act is not None:
        return F.leaky_relu(x, act)
    return x


def _pool(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """Attentive pooling over the K axis (dim 1): (rows, K, C) -> (rows, C_out)."""
    scores = torch.softmax(x @ p[f"{name}.score_fn.weight"].T, dim=1)
    return _mlp(p, f"{name}.mlp", (scores * x).sum(dim=1), "relu")


def _locse(p, name: str, centre, nbr_xyz, dist) -> torch.Tensor:
    """(rows, 3), (rows, K, 3), (rows, K) -> relu(BN(Dense(LocSE))) (rows, K, half)."""
    c = centre[:, None, :].expand_as(nbr_xyz)
    enc = torch.cat([c, nbr_xyz, c - nbr_xyz, dist[..., None]], dim=-1)
    x = enc @ p[f"{name}.mlp_rpe1.conv.kernel"] + p[f"{name}.mlp_rpe1.conv.bias"]
    return torch.relu(_bn(p, f"{name}.mlp_rpe1.batch_norm", x))


def lfa(p, name: str, xyz: torch.Tensor, feats: torch.Tensor, k: int) -> torch.Tensor:
    """One LFA block over a level's (N, 3) points and (N, C_in) features."""
    n = xyz.shape[0]
    nbr, d2 = knn(xyz, xyz, k)
    dist = torch.sqrt(d2)
    f = _mlp(p, f"{name}.mlp1", feats, 0.2)
    chunks = [slice(s, s + CHUNK) for s in range(0, n, CHUNK)]
    rpe, pooled = [], []
    for c in chunks:
        r = _locse(p, name, xyz[c], xyz[nbr[c]], dist[c])
        rpe.append(r)
        pooled.append(_pool(p, f"{name}.pool1", torch.cat([r, f[nbr[c]]], dim=-1)))
    f1 = torch.cat(pooled)
    out = []
    for c, r in zip(chunks, rpe):
        r2 = _mlp(p, f"{name}.mlp_rpe2", r, "relu")
        f2 = _pool(p, f"{name}.pool2", torch.cat([r2, f1[nbr[c]]], dim=-1))
        out.append(_mlp(p, f"{name}.mlp2", f2) + _mlp(p, f"{name}.shortcut", feats[c]))
    return F.leaky_relu(torch.cat(out), 0.01)


def forward(p, cfg: dict, inputs: torch.Tensor, permutation: torch.Tensor) -> torch.Tensor:
    """Logits (C, N) of one (N, 3 + F) cloud under a (N,) permutation."""
    n = inputs.shape[0]
    levels = len(cfg["layer_sizes"])
    k, dec = cfg["n_neighbors"], cfg["decimation"]
    x = inputs.float()
    f = F.leaky_relu(_bn(p, "bn_start", F.linear(x, p["fc_start.weight"], p["fc_start.bias"])), 0.2)
    xyz, f = x[permutation, :3].contiguous(), f[permutation]
    sizes = [n // dec**i for i in range(levels + 1)]
    skips = []
    for i in range(levels):
        f = lfa(p, f"encoder_{i}", xyz[:sizes[i]], f, k)
        skips.append(f)
        f = f[:sizes[i + 1]]
    f = _mlp(p, "mlp", f, "relu")
    for i in range(levels):
        level = levels - i
        nn1, _ = knn(xyz[:sizes[level]], xyz[:sizes[level - 1]], 1)
        f = _mlp(p, f"decoder_{i}", torch.cat([f[nn1[:, 0]], skips.pop()], dim=-1), "relu")
    out = torch.empty_like(f)
    out[permutation] = f
    out = _mlp(p, "fc_end_1", _mlp(p, "fc_end_0", out, "relu"), "relu")
    return _mlp(p, "fc_end_2", out, bn=False).T


def confidences(p, cfg: dict, inputs: torch.Tensor, permutation: torch.Tensor) -> torch.Tensor:
    """Softmax over the classes of :func:`forward`: (C, N)."""
    return torch.softmax(forward(p, cfg, inputs, permutation), dim=0)


def upsample_nearest(values: torch.Tensor, xyz: torch.Tensor, xyz_full: torch.Tensor):
    """(C, N) values at (N, 3) points -> (C, M) at (M, 3) points, each taking
    its nearest point's values."""
    nn1, _ = knn(xyz, xyz_full, 1)
    return values[:, nn1[:, 0]]
