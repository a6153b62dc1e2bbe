"""RandLA-Net encoder–decoder, eval and train forward (counterpart of
``recognizer3d_tpu/models/randlanet.py``).

Layout and flow follow the JAX package:

- features are channels-last, ``(B, N, C)`` and ``(B, N, K, C)``;
- the random-sampling hierarchy is an explicit ``permutation`` input: each
  encoder level keeps the first N/decimation^i points of the permuted
  cloud;
- every level runs in its own Morton order, computed once per level and
  shared by the encoder self-KNNs and the decoder 1-NN upsamplings; the
  level transitions are single composed gathers (the sorted-domain flow);
- BatchNorm uses eps 1e-6: in eval mode its running statistics, in train
  mode flax's batch statistics and running-average update (``BatchNorm``);
- dropout (0.5, before ``fc_end_2``) takes its keep mask as an argument in
  train mode, so a caller can hand both packages the same mask (torch
  cannot draw JAX's threefry bits).

Submodules are named after the flax paths (``encoder_0.mlp1.conv``,
``encoder_0.pool1.score_fn``, …) so ``models/weights.py`` maps archives by
a rename plus a transpose. Levels whose half width is 8 or 32 run the
fused LFA kernels (``ops/lfa_kernels.py``) in eval mode; the train forward
takes the unfused branch, as the JAX package's does, and autograd
differentiates it (the JAX package has no backward kernel).

``compute_dtype="bfloat16"`` serves the eval forward with flax's
semantics (``nn.Dense(dtype=bfloat16)`` and friends): parameters and
BatchNorm statistics stay float32; a Dense casts its input, kernel and bias
to bfloat16, rounds the product (float32 sums) and then adds the bias in
bfloat16; BatchNorm computes in float32 from its bfloat16 input and rounds
its output; activations, attentive pooling and its softmax run in bfloat16,
their sums in float32; the geometry, the neighbour search, the RPE
projections and the gather table stay float32, and the fused levels run the
LFA kernels' bfloat16 forms. The logits leave as float32.

Training in bfloat16 keeps those roundings and differentiates through
them as JAX does: each Dense's weight and bias are cast inside the autograd
graph on every forward (the cast's backward returns a float32 gradient to
the float32 master weight, as the transpose of ``convert_element_type``
does); train-mode BatchNorm takes float32 batch statistics of the upcast
input (reduced in float64 and rounded), normalises in float32 and rounds
its output once (flax's ``force_float32_reductions``); the softmax over the
neighbours has JAX's backward, operation by operation in bfloat16
(:class:`_SoftmaxBF16`); the neighbour gathers sum their cotangents in
float32 (``ops/knn.gather_neighbors``).

Initialisation follows the JAX package's torch-style U(±1/√fan) draws,
including the decoders' fan of ``n_out_ch`` (the reference's
ConvTranspose2d quirk).
"""

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from recognizer3d_tpu_torch.models.settings import RandLANetSettings
from recognizer3d_tpu_torch.ops import lfa_kernels
from recognizer3d_tpu_torch.ops.knn import gather_neighbors, knn_presorted
from recognizer3d_tpu_torch.ops.morton import (
    invert_permutation,
    morton_order,
    sort_rows,
)
from recognizer3d_tpu_torch.parallel import collectives

_BN_EPS = 1e-6
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        # jax.nn.leaky_relu multiplies by the slope cast to the input's dtype
        slope = float(torch.tensor(slope, dtype=torch.bfloat16))
    return F.leaky_relu(x, slope)


def _activation(name: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "lrelu0.2":
        return _leaky_relu(x, 0.2)
    raise ValueError(name)


def _dense(linear: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``linear(x)``; in bfloat16, flax's ``nn.Dense(dtype=bfloat16)``:
    input, weight and bias cast to bfloat16, the product rounded to
    bfloat16 (cuBLAS sums in float32: the model turns off its reduced
    precision reductions), then the bias added in bfloat16. In train mode,
    or wherever autograd records, the weights are cast afresh inside the
    graph; otherwise the cached copies serve."""
    if dtype != torch.bfloat16:
        return linear(x)
    if linear.training or torch.is_grad_enabled():
        weight = linear.weight.to(dtype)
        bias = None if linear.bias is None else linear.bias.to(dtype)
    else:
        weight, bias = _bf16_params(linear)
    y = F.linear(x.to(dtype), weight)
    return y if bias is None else y + bias


def _bf16_params(linear: nn.Linear):
    """The Dense's weight and bias cast to bfloat16, kept on the module and
    cast again only when a parameter's storage, device or version changes (a
    load, a move, an in-place update): the served forward reads the same
    copies every frame instead of casting each Dense's twice a frame. For
    inference only: the copies carry no gradient."""
    params = (linear.weight, linear.bias)
    key = tuple(None if p is None else (p.device, p.data_ptr(), p._version) for p in params)
    cached = linear.__dict__.get("_bf16_params")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, *(None if p is None else p.to(torch.bfloat16) for p in params))
        linear.__dict__["_bf16_params"] = cached
    return cached[1:]


class BatchNorm(nn.Module):
    """Channels-last BatchNorm with flax's arithmetic
    (``nn.BatchNorm(momentum=0.01, epsilon=1e-6)``):
    ``(x − mean) · (rsqrt(var + eps) · scale) + bias``.

    Eval mode reads the running statistics. Train mode reduces over every
    axis but the last, takes the variance as ``max(0, E[x²] − E[x]²)``
    (flax's ``use_fast_variance``), and updates the running statistics in
    place as ``ra = 0.01·ra + 0.99·batch`` with the biased batch variance
    (torch's own BatchNorm keeps 0.9 and stores the unbiased one).

    A bfloat16 input is normalised in float32 and the output rounded back,
    in both modes; in train mode the batch statistics are float32 values of
    the upcast input too (flax's ``force_float32_reductions``), here reduced
    in float64 and rounded, with ``rsqrt(var + eps)``. flax upcasts the
    input twice, once for the statistics and once where the normalisation
    promotes it, so the backward sums two bfloat16 cotangents: here too.

    Inside ``parallel/collectives.whole_batch()`` (data-parallel or
    point-sharded training; the default is the tensor in hand) train mode
    takes the statistics of the whole batch, as flax's BatchNorm does under
    a JAX mesh: each rank's Σx and Σx² over its block (every rank's block
    the same size) are summed over the ranks in one exchange, in the dtype of the one-rank reduction
    (float64 for a bfloat16 input), and the backward carries the
    cross-rank terms of the mean and the variance
    (``parallel/collectives.py``). The running statistics are then the
    same on every rank."""

    momentum = 0.01

    def __init__(self, n: int, eps: float = _BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            # a bfloat16 input is normalised in float32 and rounded back, as
            # flax's BatchNorm(dtype=bfloat16) does
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean) * mul + self.bias).to(x.dtype)
        wide = torch.promote_types(x.dtype, torch.float32)
        axes = tuple(range(x.dim() - 1))
        # under bfloat16 the statistics and rsqrt(var + eps) are taken in
        # float64 and rounded to float32, the correctly rounded values of
        # flax's float32 operations: a float32 error there would flip a share
        # of the output's bfloat16 roundings, and which ones would depend on
        # the device's summation order
        exact = torch.float64 if x.dtype == torch.bfloat16 else wide
        xs = x.to(exact)
        ranks = collectives.batch_ranks()
        if ranks == 1:
            mean = xs.mean(axes)
            var = torch.clamp((xs * xs).mean(axes) - mean * mean, min=0.0)
        else:
            n = xs.numel() // xs.shape[-1] * ranks
            s1, s2 = collectives.replicated_sum(xs.sum(axes), (xs * xs).sum(axes))
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
        mean, var = mean.to(wide), var.to(wide)
        inv = torch.rsqrt((var + self.eps).to(exact)).to(wide)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        if ranks > 1:
            mean, inv = collectives.to_ranks(mean, inv)
        return ((x.to(wide) - mean) * (inv * self.weight) + self.bias).to(x.dtype)

    def eval_affine(self):
        """Exact per-channel ``(s, o)`` with ``BN(x) = s·x + o``, read from
        the raw variables."""
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s


class SharedMLP(nn.Module):
    """Dense + BatchNorm + activation over the trailing channel dim.

    The Dense draws weight and bias from U(±1/√fan), fan = ``n_in`` (torch's
    ``nn.Linear`` default) unless ``init_fan`` overrides it, as the JAX
    package does for the decoders. ``dtype`` is the activation dtype."""

    def __init__(self, n_in: int, n_out: int, bn: bool = True,
                 activation: Optional[str] = None, init_fan: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.compute_dtype = dtype
        self.conv = nn.Linear(n_in, n_out)
        if init_fan is not None:
            bound = 1.0 / init_fan**0.5
            with torch.no_grad():
                self.conv.weight.uniform_(-bound, bound)
                self.conv.bias.uniform_(-bound, bound)
        self.batch_norm = BatchNorm(n_out) if bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _dense(self.conv, x, self.compute_dtype)
        if self.batch_norm is not None:
            x = self.batch_norm(x)
        return _activation(self.activation, x)

    def dense_wb(self):
        """(W (n_in, n_out), b (n_out,)) in the JAX package's layout."""
        return self.conv.weight.t(), self.conv.bias


class _RPEKernel(nn.Module):
    """Holds ``mlp_rpe1``'s raw (10, half) Dense kernel whole, as flax does."""

    def __init__(self, half: int):
        super().__init__()
        bound = 1.0 / 10**0.5
        self.kernel = nn.Parameter(torch.empty(10, half).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(half).uniform_(-bound, bound))


class FusedRPEMLP(nn.Module):
    """``mlp_rpe1`` over the 10-channel LocSE encoding
    ``[center, nbr, center − nbr, dist]``, split exactly into
    ``(Wc + Wd)·center + (Wn − Wd)·nbr + w9·dist + b``: the neighbour term
    is a projection of the support cloud that rides the neighbour gather.
    The encoding sums in float32; in bfloat16 it is rounded before the
    BatchNorm."""

    def __init__(self, half: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv = _RPEKernel(half)
        self.batch_norm = BatchNorm(half)

    def support_projection(self, xyz: torch.Tensor) -> torch.Tensor:
        k = self.conv.kernel
        return xyz.to(k.dtype) @ (k[3:6] - k[6:9])

    def center_projection(self, xyz: torch.Tensor) -> torch.Tensor:
        k = self.conv.kernel
        return xyz.to(k.dtype) @ (k[0:3] + k[6:9])

    def forward(self, xyz, q_gathered, distances) -> torch.Tensor:
        """(B, N, 3), (B, N, K, half), (B, N, K) -> (B, N, K, half)."""
        k = self.conv.kernel
        center = self.center_projection(xyz)
        out = (
            center[:, :, None, :]
            + q_gathered
            + distances[..., None] * k[9]
            + self.conv.bias
        )
        if self.compute_dtype == torch.bfloat16:
            out = out.to(torch.bfloat16)
        return torch.relu(self.batch_norm(out))


class _SoftmaxBF16(torch.autograd.Function):
    """``jax.nn.softmax`` over dim −2 of a bfloat16 tensor, forward and
    backward. Forward: ``u = exp(x − max)`` and ``u / Σu``, each operation
    rounded to bfloat16, the sum accumulated in float32 and rounded once
    (``jnp.sum`` upcasts). Backward: what JAX's autodiff of that program
    computes (no custom JVP; the max is a ``stop_gradient``), each
    operation rounded to bfloat16: ``c = 1/(s·s)``, ``t = −(g·c)·u``,
    ``ū = g/s + Σt``, ``x̄ = ū·u``. The sum Σt is the transpose of a
    broadcast, a bfloat16 reduction in XLA; here it accumulates in float32
    and rounds once."""

    @staticmethod
    def forward(ctx, x):
        u = torch.exp(x - x.amax(dim=-2, keepdim=True))
        s = u.float().sum(dim=-2, keepdim=True).to(u.dtype)
        ctx.save_for_backward(u, s)
        return u / s

    @staticmethod
    def backward(ctx, g):
        u, s = ctx.saved_tensors
        c = 1.0 / (s * s)
        t = -((g * c) * u)
        u_bar = g / s + t.float().sum(dim=-2, keepdim=True).to(t.dtype)
        return u_bar * u


class AttentivePooling(nn.Module):
    """Attention over the K neighbours: (B, N, K, C) -> (B, N, n_out).

    In bfloat16 the softmax is ``jax.nn.softmax``'s (:class:`_SoftmaxBF16`):
    each operation rounds to bfloat16, the sums (its normaliser and the
    pooled sum) accumulate in float32 and round once."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.score_fn = nn.Linear(n_in, n_in, bias=False)
        self.mlp = SharedMLP(n_in, n_out, activation="relu", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scores = _dense(self.score_fn, x, self.compute_dtype)
        if self.compute_dtype != torch.bfloat16:
            scores = torch.softmax(scores, dim=-2)  # softmax over K
            return self.mlp((scores * x).sum(dim=-2))
        scores = _SoftmaxBF16.apply(scores)
        return self.mlp((scores * x.to(scores.dtype)).float().sum(dim=-2).to(scores.dtype))

    def score_kernel(self) -> torch.Tensor:
        return self.score_fn.weight.t()


class LocalFeatureAggregation(nn.Module):
    """The RandLA-Net LFA block: one self-KNN, two rounds of (RPE-MLP →
    neighbour-feature concat → attentive pooling), then
    ``lrelu(mlp2(features) + shortcut(input))`` -> (B, N, 2·n_out).

    ``features`` rows follow ``xyz``'s order (any order: the search and
    every reduction are order-agnostic) and the output keeps it.

    With a ``backend`` (``parallel/sp_model.SPBackend``), ``xyz`` and
    ``features`` are this rank's blocks of point-sharded tensors: the
    self-KNN and the first neighbour gather are one ring pass, the second
    gather another, and the block runs unfused (the eval kernels take a
    whole level's neighbour rows), as the JAX block does."""

    def __init__(self, n_in: int, n_out: int, n_neighbors: int, knn_approach: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = n_out // 2
        dt = self.compute_dtype = dtype
        self.n_neighbors = n_neighbors
        self.knn_approach = knn_approach
        self.half = half
        self.mlp1 = SharedMLP(n_in, half, activation="lrelu0.2", dtype=dt)
        self.mlp_rpe1 = FusedRPEMLP(half, dtype=dt)
        self.pool1 = AttentivePooling(n_out, half, dtype=dt)
        self.mlp_rpe2 = SharedMLP(half, half, activation="relu", dtype=dt)
        self.pool2 = AttentivePooling(n_out, n_out, dtype=dt)
        self.mlp2 = SharedMLP(n_out, 2 * n_out, dtype=dt)
        self.shortcut = SharedMLP(n_in, 2 * n_out, dtype=dt)

    def fused(self) -> bool:
        """Whether the eval forward runs the fused LFA kernels."""
        return not self.training and lfa_kernels.supports(
            self.n_neighbors, self.half, str(self.compute_dtype).removeprefix("torch.")
        )

    def forward(self, xyz: torch.Tensor, features: torch.Tensor, backend=None) -> torch.Tensor:
        half = self.half
        fused = backend is None and self.fused()
        feats = self.mlp1(features)
        # the mlp_rpe1 neighbour term and the feature rows share one gather;
        # the table is float32 (bfloat16 rows round after the gather, or,
        # for the kernels' bfloat16 form, before it: the same values)
        support = self.mlp_rpe1.support_projection(xyz)
        table = torch.cat([support, feats.to(support.dtype)], dim=-1)
        if fused and self.compute_dtype == torch.bfloat16:
            table = table.to(torch.bfloat16)
        if backend is None:
            neighbors, d2 = knn_presorted(xyz, xyz, self.n_neighbors, self.knn_approach)
            gathered = gather_neighbors(table, neighbors)  # (B, N, K, 2·half)
        else:
            neighbors, d2, gathered = backend.knn_gather(xyz, xyz, table, self.n_neighbors)
        if fused:
            s1, o1 = self.mlp_rpe1.batch_norm.eval_affine()
            wp1, bp1 = self.pool1.mlp.dense_wb()
            sp1, op1 = self.pool1.mlp.batch_norm.eval_affine()
            w2, b2 = self.mlp_rpe2.dense_wb()
            s2, o2 = self.mlp_rpe2.batch_norm.eval_affine()
            pooled1, rpe2 = lfa_kernels.lfa_round1(
                gathered, d2, self.mlp_rpe1.center_projection(xyz),
                self.mlp_rpe1.conv.kernel[9], self.mlp_rpe1.conv.bias, s1, o1,
                self.pool1.score_kernel(), wp1, bp1, sp1, op1, w2, b2, s2, o2,
            )
            g2 = gather_neighbors(pooled1, neighbors)
            wp2, bp2 = self.pool2.mlp.dense_wb()
            sp2, op2 = self.pool2.mlp.batch_norm.eval_affine()
            wm, bm = self.mlp2.dense_wb()
            sm, om = self.mlp2.batch_norm.eval_affine()
            wsh, bsh = self.shortcut.dense_wb()
            ssh, osh = self.shortcut.batch_norm.eval_affine()
            return lfa_kernels.attentive_pool2_residual(
                rpe2, g2, self.pool2.score_kernel(), wp2, bp2, sp2, op2,
                features.contiguous(), wm * sm[None, :], wsh * ssh[None, :],
                (sm * bm + om) + (ssh * bsh + osh), k=self.n_neighbors,
            )
        distances = torch.sqrt(d2)
        rpe = self.mlp_rpe1(xyz, gathered[..., :half], distances)
        cat = torch.cat([rpe, gathered[..., half:].to(rpe.dtype)], dim=-1)  # (B, N, K, n_out)
        feats = self.pool1(cat)
        rpe = self.mlp_rpe2(rpe)
        if backend is None:
            neighbor_feats = gather_neighbors(feats, neighbors)
        else:
            neighbor_feats = backend.gather(feats, neighbors)
        feats = self.pool2(torch.cat([rpe, neighbor_feats], dim=-1))
        out = self.mlp2(feats) + self.shortcut(features)
        return _leaky_relu(out, 0.01)


def upsample_nni(features, xyz, xyz_upsampled, knn_approach: str) -> torch.Tensor:
    """1-NN feature copy: each upsampled point takes the features of its
    nearest coarse point; rows follow ``xyz_upsampled``'s order."""
    neighbors, _ = knn_presorted(xyz, xyz_upsampled, 1, knn_approach)
    return gather_neighbors(features, neighbors)[:, :, 0, :]


def bn_absorbed_biases(names) -> Dict[str, str]:
    """``{bias: weight}`` for each Dense among the parameter (or state-dict)
    ``names`` whose output feeds a train-mode BatchNorm. The batch mean
    absorbs such a bias, so its gradient is 0 in exact arithmetic and
    rounding noise in float32: a check of gradients scales its tolerance by
    the weight's."""
    names = set(names)
    out = {"fc_start.bias": "fc_start.weight"} if "bn_start.weight" in names else {}
    for name in names:
        if name.endswith("conv.bias"):
            parent = name[: -len("conv.bias")]
            if parent + "batch_norm.weight" in names:
                weight = parent + "conv.weight"
                out[name] = weight if weight in names else parent + "conv.kernel"
    return out


class RandLANet(nn.Module):
    """Full encoder–decoder: ``forward(inputs (B, N, 3+F), permutation (N,),
    dropout_mask=None)`` returns logits (B, C, N) in the original point
    order. ``dropout_mask`` is the train-mode keep mask (B, N, 32) bool
    (flax's ``Dropout(0.5)``: kept features doubled, the rest zeroed);
    without one, train mode draws it from torch's global generator. Eval
    mode ignores it. In bfloat16 the kept features are doubled in bfloat16
    (exact). A module in double (``.double()``) computes in
    float64 but for the geometry and the neighbour search, which stay
    float32: the reference a float32 step is held against.

    With a ``backend`` (``parallel/sp_model.SPBackend``) the forward runs
    point-sharded (:meth:`_forward_sharded`), in eval or train mode."""

    dropout_rate = 0.5

    def __init__(self, settings: RandLANetSettings):
        super().__init__()
        # Full float32 matmuls on the card: TF32 keeps ~3 decimal digits,
        # which would move the neighbour geometry (the RPE projections) and
        # break the float32 parity contract with the JAX package. bfloat16
        # matmuls sum in float32, as the JAX package's dots do
        # (preferred_element_type): cuBLAS may not reduce in bfloat16.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.settings = s = settings
        dt = self.compute_dtype = _DTYPES[s.compute_dtype]
        dim = 3 + s.n_features
        self.fc_start = nn.Linear(dim, 8)
        self.bn_start = BatchNorm(8)
        n_in = 8
        for i, n_out in enumerate(s.layer_sizes):
            self.add_module(
                f"encoder_{i}",
                LocalFeatureAggregation(n_in, n_out, s.n_neighbors, s.knn, dt),
            )
            n_in = 2 * n_out
        self.mlp = SharedMLP(n_in, n_in, activation="relu", dtype=dt)
        n_outs = list(s.layer_sizes[::-1][1:])
        decoder_channels = [2 * n for n in n_outs] + [8]
        skips = [2 * n for n in s.layer_sizes[::-1]]
        for i, (n_out_ch, skip) in enumerate(zip(decoder_channels, skips)):
            self.add_module(
                f"decoder_{i}",
                SharedMLP(n_in + skip, n_out_ch, activation="relu", init_fan=n_out_ch,
                          dtype=dt),
            )
            n_in = n_out_ch
        self.fc_end_0 = SharedMLP(8, 64, activation="relu", dtype=dt)
        self.fc_end_1 = SharedMLP(64, 32, activation="relu", dtype=dt)
        self.fc_end_2 = SharedMLP(32, s.n_classes, bn=False, dtype=dt)

    def forward(self, inputs: torch.Tensor, permutation: Optional[torch.Tensor],
                dropout_mask: Optional[torch.Tensor] = None, backend=None) -> torch.Tensor:
        with torch.profiler.record_function("r3d.forward"):
            if backend is not None:
                return self._forward_sharded(inputs, backend, dropout_mask)
            return self._forward_dense(inputs, permutation, dropout_mask)

    def _forward_dense(self, inputs: torch.Tensor, permutation: torch.Tensor,
                       dropout_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The forward on one device: per-level Morton orders of the permuted
        cloud, the encoder, the decoder's 1-NN upsamples and the head."""
        s = self.settings
        B, N, dim = inputs.shape
        assert dim == 3 + s.n_features, "Input should have shape (B, N, 3 + F)!"
        assert N >= s.min_n_points, (
            f"Input point cloud should have at least {s.min_n_points} points!"
        )
        permutation = permutation.long()
        xyz = inputs[..., :3].float()
        # fc_start casts all of its input, xyz included, to the compute dtype
        feats = _leaky_relu(self.bn_start(_dense(self.fc_start, inputs, self.compute_dtype)), 0.2)

        level_sizes = [N]
        for i in range(s.n_layers):
            level_sizes.append(N // s.decimation ** (i + 1))

        # per-level Morton orders of the permuted cloud's prefixes, shared by
        # the encoder self-KNNs and the decoder upsamplings
        xyz = sort_rows(xyz, permutation)
        orders: List[torch.Tensor] = []
        invs: List[torch.Tensor] = []
        xyz_levels: List[torch.Tensor] = []
        for n_level in level_sizes:
            x_level = xyz[:, :n_level]
            order = morton_order(x_level)
            orders.append(order)
            invs.append(invert_permutation(order))
            xyz_levels.append(sort_rows(x_level, order))

        # encoder: features stay in each level's Morton order; a level
        # transition is one composed gather (inv_i ∘ order_{i+1})
        feats = sort_rows(feats, permutation[orders[0]])
        skip_stack = []
        for i in range(s.n_layers):
            feats = getattr(self, f"encoder_{i}")(xyz_levels[i], feats)
            skip_stack.append(feats)
            feats = sort_rows(feats, torch.gather(invs[i], 1, orders[i + 1]))

        feats = self.mlp(feats)

        # decoder: each 1-NN upsample lands in the finer level's sorted order
        for i in range(s.n_layers):
            level = s.n_layers - i
            up = upsample_nni(feats, xyz_levels[level], xyz_levels[level - 1], s.knn)
            feats = torch.cat([up, skip_stack.pop()], dim=-1)
            feats = getattr(self, f"decoder_{i}")(feats)

        # back to the original point order: inv_0 ∘ permutation⁻¹ in one gather
        feats = sort_rows(feats, invs[0][:, invert_permutation(permutation)])

        feats = self._dropout(self.fc_end_1(self.fc_end_0(feats)), dropout_mask)
        feats = self.fc_end_2(feats)
        # (B, C, N), float32 at least (a float64 module keeps float64)
        return feats.transpose(-1, -2).to(torch.promote_types(feats.dtype, torch.float32))

    def _dropout(self, feats: torch.Tensor, dropout_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Train mode: flax's ``Dropout(0.5)`` with the keep mask given (or
        drawn from torch's global generator); eval mode: the identity."""
        if not self.training:
            return feats
        if dropout_mask is None:
            dropout_mask = torch.rand(feats.shape, device=feats.device) < 1.0 - self.dropout_rate
        return torch.where(dropout_mask, feats / (1.0 - self.dropout_rate),
                           torch.zeros_like(feats))

    def _forward_sharded(self, inputs: torch.Tensor, backend,
                         dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The forward over a point-sharded cloud (JAX's ``backend=``
        branch): ``inputs`` (B, N/D, 3+F) is this rank's block of the cloud
        already in its random-sampling permutation (the caller permutes on
        the host: JAX's in-model permutation and its inverse are
        all-to-alls), and the logits (B, C, N/D) keep that order. Levels
        stay in permuted order, with no Morton sorts (the ring search is
        order-agnostic); each decimation prefix is rebalanced onto the
        block layout; each decoder upsample is a ring 1-NN pass.

        Train mode runs inside ``parallel/collectives.whole_batch()``: there
        BatchNorm takes the statistics of every point of every rank, and
        ``dropout_mask`` is this rank's block of the keep mask in the same
        permuted order (the rows of the one-device mask at the
        caller's permutation); the caller permutes the labels likewise (the
        losses and metrics are sums over points, in any order)."""
        s = self.settings
        B, n_loc, dim = inputs.shape
        N = n_loc * backend.n_shards
        assert dim == 3 + s.n_features, "Input should have shape (B, N, 3 + F)!"
        assert N >= s.min_n_points, (
            f"Input point cloud should have at least {s.min_n_points} points!"
        )
        if self.training and backend.n_shards > 1 and collectives.batch_ranks() == 1:
            raise ValueError("the point-sharded train forward runs inside "
                             "parallel.collectives.whole_batch(), so that BatchNorm takes the "
                             "statistics of every rank's points")
        level_sizes = [N // s.decimation**i for i in range(s.n_layers + 1)]
        backend.check_level_sizes(level_sizes)
        xyz_levels = [inputs[..., :3].float()]
        for n_level in level_sizes[1:]:
            xyz_levels.append(backend.constrain(xyz_levels[-1], n_level))
        feats = _leaky_relu(self.bn_start(_dense(self.fc_start, inputs, self.compute_dtype)), 0.2)
        skip_stack = []
        for i in range(s.n_layers):
            feats = getattr(self, f"encoder_{i}")(xyz_levels[i], feats, backend=backend)
            skip_stack.append(feats)
            feats = backend.constrain(feats, level_sizes[i + 1])
        feats = self.mlp(feats)
        for i in range(s.n_layers):
            level = s.n_layers - i
            _, _, up = backend.knn_gather(xyz_levels[level], xyz_levels[level - 1], feats, 1)
            feats = torch.cat([up[:, :, 0, :], skip_stack.pop()], dim=-1)
            feats = getattr(self, f"decoder_{i}")(feats)
        feats = self._dropout(self.fc_end_1(self.fc_end_0(feats)), dropout_mask)
        feats = self.fc_end_2(feats)
        return feats.transpose(-1, -2).to(torch.promote_types(feats.dtype, torch.float32))
