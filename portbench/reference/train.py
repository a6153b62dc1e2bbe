"""RandLA-Net's train step in plain PyTorch, float32: batches assembled from
the same seeded draws the training recipe makes, the train-mode forward,
the Dice loss, autograd's backward and Adam, written from their
definitions. Nothing of the measured package is imported.

The recipe's draws, in order, from one ``torch.Generator`` on the device
seeded by the trainer's seed: an epoch's shuffle of the clouds
(``randperm``); for each batch of clouds, a uniform draw for duplicates
(unused: every cloud has ``n_points`` points or more), the uniform
priorities of every point (a cloud keeps its ``n_points`` lowest, in rising
order, ties to the lower index), the augmentation's jitter normals, scales,
angle normals and shifts; then the random-sampling permutation of the
batch and the dropout keep mask.

BatchNorm in train mode normalises by the batch's own statistics (the mean
and the biased variance over every axis but the channels); dropout keeps a
feature where the mask says and doubles it. Dice is the focal Tversky index
at alpha 0.5 and gamma 1 over class 1, summed over every point of the
batch. Adam: beta 0.9 / 0.999, eps 1e-8, bias-corrected.
"""

from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.knn import knn

BN_EPS = 1e-6
ADAM = (0.9, 0.999, 1e-8)
DICE_EPS = 1e-7


def batches(cfg: dict, aug: dict, xyz: torch.Tensor, labels: torch.Tensor, seed: int,
            batch: int, count: int) -> Iterator[Tuple[torch.Tensor, ...]]:
    """The first ``count`` batches (inputs (B, N, 3), labels (B, N), the
    batch's permutation (N,), keep mask (B, N, 32)) of the recipe's first
    epoch over the clouds ``xyz`` (S, M, 3), ``labels`` (S, M)."""
    dev, n = xyz.device, cfg["n_points"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    order = torch.randperm(xyz.shape[0], generator=g, device=dev)
    for i in range(count):
        ids = order[i * batch:(i + 1) * batch]
        b = len(ids)
        torch.rand((b, n), generator=g, device=dev)
        priority = torch.rand((b, xyz.shape[1]), generator=g, device=dev)
        jitter = torch.randn((b, n, 3), generator=g, device=dev)
        lo, hi = 1 - aug["scale_limit"], 1 + aug["scale_limit"]
        scale = torch.rand((b,), generator=g, device=dev) * (hi - lo) + lo
        angles = torch.randn((b, 3), generator=g, device=dev)
        lo, hi = -aug["shift_limit"], aug["shift_limit"]
        shift = torch.rand((b, 3), generator=g, device=dev) * (hi - lo) + lo
        keep_idx = torch.sort(priority, dim=1, stable=True).indices[:, :n]
        pts = torch.gather(xyz[ids], 1, keep_idx[..., None].expand(-1, -1, 3))
        labs = torch.gather(labels[ids], 1, keep_idx)
        pts = augment(pts, aug, jitter, scale, angles, shift)
        perm = torch.randperm(n, generator=g, device=dev)
        keep = torch.rand((b, n, 32), generator=g, device=dev) < 0.5
        yield pts, labs, perm, keep


def _radius(xyz):
    d = xyz - xyz.mean(dim=1, keepdim=True)
    return torch.sqrt((d * d).sum(-1)).mean(dim=1)


def augment(xyz, aug, jitter, scale, angles, shift):
    """Jitter (scaled by the cloud's mean radius, clipped), scaling about the
    centroid, rotation about the centroid by clipped angles (R = Rz·Ry·Rx),
    then a shift scaled by the mean radius."""
    noise = (_radius(xyz)[:, None, None] * aug["jitter_variance"] * jitter).clamp(
        -aug["jitter_limit"], aug["jitter_limit"])
    xyz = xyz + noise
    c = xyz.mean(dim=1, keepdim=True)
    xyz = (xyz - c) * scale[:, None, None] + c
    sig = torch.tensor(aug["rotation_angle_variances"], dtype=xyz.dtype, device=xyz.device)
    lim = torch.tensor(aug["rotation_angle_limits"], dtype=xyz.dtype, device=xyz.device)
    a = torch.minimum(torch.maximum(sig * angles, -lim), lim)
    cos, sin = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(cos[:, 0]), torch.zeros_like(cos[:, 0])
    rx = torch.stack([one, zero, zero, zero, cos[:, 0], -sin[:, 0], zero, sin[:, 0], cos[:, 0]], -1)
    ry = torch.stack([cos[:, 1], zero, sin[:, 1], zero, one, zero, -sin[:, 1], zero, cos[:, 1]], -1)
    rz = torch.stack([cos[:, 2], -sin[:, 2], zero, sin[:, 2], cos[:, 2], zero, zero, zero, one], -1)
    rot = rz.view(-1, 3, 3) @ ry.view(-1, 3, 3) @ rx.view(-1, 3, 3)
    c = xyz.mean(dim=1, keepdim=True)
    xyz = (xyz - c) @ rot.transpose(-1, -2) + c
    return xyz + _radius(xyz)[:, None, None] * shift[:, None, :]


def _bn(p, name, x):
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(axes)
    var = ((x - mean) ** 2).mean(axes)
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[f"{name}.weight"] + p[f"{name}.bias"]


def _mlp(p, name, x, act=None, bn=True):
    x = F.linear(x, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"])
    if bn:
        x = _bn(p, f"{name}.batch_norm", x)
    if act == "relu":
        return torch.relu(x)
    return x if act is None else F.leaky_relu(x, act)


def _pool(p, name, x):
    scores = torch.softmax(x @ p[f"{name}.score_fn.weight"].T, dim=-2)
    return _mlp(p, f"{name}.mlp", (scores * x).sum(dim=-2), "relu")


def _rows(x, idx):
    """Per cloud rows: x (B, N, C), idx (B, M, ...) -> (B, M, ..., C)."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def _lfa(p, name, xyz, feats, k):
    found = [knn(c, c, k) for c in xyz]
    nbr = torch.stack([f[0] for f in found])
    dist = torch.sqrt(torch.stack([f[1] for f in found]))
    f = _mlp(p, f"{name}.mlp1", feats, 0.2)
    centre = xyz[:, :, None, :].expand(-1, -1, k, -1)
    nxyz = _rows(xyz, nbr)
    enc = torch.cat([centre, nxyz, centre - nxyz, dist[..., None]], dim=-1)
    rpe = enc @ p[f"{name}.mlp_rpe1.conv.kernel"] + p[f"{name}.mlp_rpe1.conv.bias"]
    rpe = torch.relu(_bn(p, f"{name}.mlp_rpe1.batch_norm", rpe))
    f1 = _pool(p, f"{name}.pool1", torch.cat([rpe, _rows(f, nbr)], dim=-1))
    r2 = _mlp(p, f"{name}.mlp_rpe2", rpe, "relu")
    f2 = _pool(p, f"{name}.pool2", torch.cat([r2, _rows(f1, nbr)], dim=-1))
    out = _mlp(p, f"{name}.mlp2", f2) + _mlp(p, f"{name}.shortcut", feats)
    return F.leaky_relu(out, 0.01)


def forward(p, cfg, inputs, perm, keep):
    """Train-mode logits (B, C, N) of a batch (B, N, 3) under one permutation."""
    n = inputs.shape[1]
    levels = len(cfg["layer_sizes"])
    k, dec = cfg["n_neighbors"], cfg["decimation"]
    f = F.leaky_relu(_bn(p, "bn_start", F.linear(inputs, p["fc_start.weight"],
                                                 p["fc_start.bias"])), 0.2)
    xyz, f = inputs[:, perm, :3].contiguous(), f[:, perm]
    sizes = [n // dec**i for i in range(levels + 1)]
    skips = []
    for i in range(levels):
        f = _lfa(p, f"encoder_{i}", xyz[:, :sizes[i]].contiguous(), f, k)
        skips.append(f)
        f = f[:, :sizes[i + 1]]
    f = _mlp(p, "mlp", f, "relu")
    for i in range(levels):
        level = levels - i
        nn1 = torch.stack([knn(c[:sizes[level]], c[:sizes[level - 1]], 1)[0] for c in xyz])
        f = _mlp(p, f"decoder_{i}", torch.cat([_rows(f, nn1)[:, :, 0], skips.pop()], -1), "relu")
    out = torch.empty_like(f)
    out[:, perm] = f
    out = _mlp(p, "fc_end_1", _mlp(p, "fc_end_0", out, "relu"), "relu")
    out = torch.where(keep, out / 0.5, torch.zeros_like(out))
    return _mlp(p, "fc_end_2", out, bn=False).transpose(1, 2)


def dice_loss(logits, labels):
    y_pred = torch.softmax(logits, dim=1)[:, 1]
    y_true = (labels == 1).to(logits.dtype)
    tp = (y_true * y_pred).sum()
    fn = (y_true * (1 - y_pred)).sum()
    fp = ((1 - y_true) * y_pred).sum()
    return 1 - (tp + DICE_EPS) / (tp + 0.5 * fn + 0.5 * fp + DICE_EPS)


def train(p0: Dict[str, torch.Tensor], cfg, batches_iter, lr: float, steps: int):
    """``steps`` steps of Adam from the parameters ``p0`` (Dense weights,
    biases, LocSE kernels, BatchNorm scales and offsets; running statistics
    are ignored). Returns (each step's loss, the first step's gradients,
    the parameters after the last step)."""
    names = [k for k in p0 if not k.endswith(("running_mean", "running_var"))]
    p = {k: p0[k].detach().clone().requires_grad_(k in names) for k in p0}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    b1, b2, eps = ADAM
    losses, first = [], None
    for t, (x, y, perm, keep) in zip(range(1, steps + 1), batches_iter):
        loss = dice_loss(forward(p, cfg, x, perm, keep), y)
        grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: torch.zeros_like(p[k]) if gr is None else gr for k, gr in zip(names, grads)}
            if first is None:
                first = g
            for k in names:
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                step = lr / (1 - b1**t)
                denom = (v[k] / (1 - b2**t)).sqrt() + eps
                p[k] -= step * m[k] / denom
    return losses, first, {k: p[k].detach() for k in names}


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             keys) -> float:
    """The widest gap, over the leaves ``keys``, between the program's norm
    of a leaf and the reference's, as a share of the larger of that leaf's
    reference norm and the median leaf's."""
    ref_norms = {k: float(reference[k].norm()) for k in keys}
    median = sorted(ref_norms.values())[len(ref_norms) // 2]
    return max(abs(float(program[k].norm()) - ref_norms[k]) / max(ref_norms[k], median, 1e-30)
               for k in keys)


def moved_leaves(first_grads: Dict[str, torch.Tensor]):
    """The leaves whose first gradient's norm is at least a thousandth of the
    median leaf's: the others (biases that a train-mode BatchNorm's mean
    absorbs) move under Adam by round-off alone."""
    norms = {k: float(g.norm()) for k, g in first_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * median]


