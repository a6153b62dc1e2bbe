"""The PyTorch port's bfloat16 compute mode against the JAX package's.

The fused LFA kernels' bfloat16 forms (plain versions) against the Pallas
kernels compiled with ``io = bfloat16`` in interpret mode, LFA blocks (fused
and unfused) and the whole RandLA-Net in bfloat16 against the JAX package's
bfloat16 forward, the rule that holds the card's bfloat16 logits against
the CPU's (``bf16_card_vs_cpu.logits_agree``), the archive round trip, and
what bfloat16 leaves alone (the neighbour search). Blocks and the
model are held nearer JAX's bfloat16 forward than its float32 one; the
port's float32 forward, the control, is not.

Tolerances. Where both sides round the same float32 value to bfloat16, a
float32 difference from another summation order moves the result by at most
one bfloat16 ulp: |Δ| ≤ 2⁻⁷·|ref| + 1e-6. Inside the kernels an
intermediate is rounded too (the concatenation before the score dot, each
product w·x before the pooled sum, pool 2's pooled row before the mlp2
dot); when the two sides round one to different sides of a midpoint, the
outputs it feeds move by one ulp of that intermediate, which near a
cancellation is more than one ulp of the output. So every kernel output is
held to ``_ulp_stats``: at least 99.9% of the elements within one ulp of
the reference, every element within one ulp of itself plus one ulp of its
row's largest magnitude, and at least 99% bit-identical (measured here:
99.87–100% identical, at most 4 of 25,600 elements beyond one ulp, all in
pool 2 + residual at h = 32).
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.ops import lfa_pallas
from recognizer3d_tpu_torch import Model, Predictor, RandLANetSettings
from recognizer3d_tpu_torch.benchmarks.bf16_card_vs_cpu import logits_agree
from recognizer3d_tpu_torch.data import pipeline
from recognizer3d_tpu_torch.models.live import LivePredictor
from recognizer3d_tpu_torch.models import randlanet as port_rl
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.ops import lfa_kernels
from tests.test_torch_port_model import ARCHIVE, _flax_variables, _make_frame

BF16 = torch.bfloat16

# XLA may keep a bfloat16 intermediate in float32 inside a fusion
# (``xla_allow_excess_precision``, on by default), which on the CPU drops
# roundings the program asks for (a softmax's, a Dense's). The JAX forwards in
# bfloat16 are compiled without it, so that every operation rounds where the
# program says, as the port's operations do.
_jit_bf16 = partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture
def force_fused():
    jax_rl.FORCE_FUSED_LFA_INTERPRET = True
    yield
    jax_rl.FORCE_FUSED_LFA_INTERPRET = False


def _ulp_stats(got, ref):
    """(share within one bfloat16 ulp, share bit-identical, every element
    within one ulp of itself plus one of its row's largest magnitude)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    d = np.abs(got - ref)
    row = np.abs(ref).max(axis=-1, keepdims=True)
    within = d <= 2.0**-7 * np.abs(ref) + 1e-6
    carried = d <= 2.0**-7 * (np.abs(ref) + row) + 1e-6
    return within.mean(), (d == 0).mean(), bool(carried.all())


def _assert_bf16_close(got: torch.Tensor, ref, shape):
    assert got.dtype == BF16 and tuple(got.shape) == shape
    within, same, carried = _ulp_stats(got.float().numpy(), np.asarray(ref, np.float32))
    assert within >= 0.999 and same >= 0.99 and carried, (within, same, carried)


def _bf16(a: np.ndarray):
    """The same bfloat16 values for both packages: (torch, jax)."""
    t = torch.from_numpy(a).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _jax_f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rand(rng, *shape, scale=0.3):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _pos(rng, *shape):
    return rng.uniform(0.5, 1.5, shape).astype(np.float32)


# --- the kernels' bfloat16 forms -------------------------------------------------


@pytest.mark.parametrize("h,n", [(8, 300), (32, 200)])
def test_round1_bf16_plain_matches_pallas_kernel(h, n):
    rng = np.random.RandomState(h)
    k, c2 = 32, 2 * h
    gathered, gathered_j = _bf16(_rand(rng, 1, n, k, c2, scale=0.5))
    rest = [
        rng.uniform(0, 0.01, (1, n, k)).astype(np.float32),  # d2
        _rand(rng, 1, n, h),                                 # center term
        _rand(rng, h), _rand(rng, h),                        # w9, b1
        _pos(rng, h), _rand(rng, h),                         # s1, o1
        _rand(rng, c2, c2),                                  # ws
        _rand(rng, c2, h), _rand(rng, h),                    # wp, bp
        _pos(rng, h), _rand(rng, h),                         # sp, op
        _rand(rng, h, h), _rand(rng, h),                     # w2, b2
        _pos(rng, h), _rand(rng, h),                         # s2, o2
    ]
    fused = jax.jit(lambda *a: lfa_pallas.lfa_round1_fused(*a, interpret=True))
    pooled_j, rpe2_j = fused(gathered_j, *[jnp.asarray(a) for a in rest])
    pooled, rpe2 = lfa_kernels.lfa_round1(gathered, *[torch.from_numpy(a) for a in rest])
    _assert_bf16_close(pooled, _jax_f32(pooled_j), (1, n, h))
    _assert_bf16_close(rpe2.reshape(1, n, k, h), _jax_f32(rpe2_j).reshape(1, n, k, h),
                       (1, n, k, h))


def _pool2_args(h, f, n, seed):
    rng = np.random.RandomState(seed)
    k, c2 = 32, 2 * h
    rpe2 = _bf16(np.abs(_rand(rng, 1, n, k * h, scale=0.5)))  # post-relu
    g2 = _bf16(np.abs(_rand(rng, 1, n, k, h, scale=0.5)))
    head = [_rand(rng, c2, c2), _rand(rng, c2, c2), _rand(rng, c2), _pos(rng, c2), _rand(rng, c2)]
    f_in = _bf16(_rand(rng, 1, n, f, scale=1.0))
    tail = [_rand(rng, c2, 4 * h), _rand(rng, f, 4 * h), _rand(rng, 4 * h)]
    return rpe2, g2, head, f_in, tail


@pytest.mark.parametrize("h,f,n", [(8, 8, 300), (32, 32, 200)])
def test_pool2_residual_bf16_plain_matches_pallas_kernel(h, f, n):
    (r, r_j), (g, g_j), head, (f_in, f_j), tail = _pool2_args(h, f, n, h + f)
    fused = jax.jit(lambda *a: lfa_pallas.attentive_pool2_residual_fused(*a, k=32,
                                                                        interpret=True))
    ref = fused(r_j, g_j, *map(jnp.asarray, head), f_j, *map(jnp.asarray, tail))
    out = lfa_kernels.attentive_pool2_residual(
        r, g, *map(torch.from_numpy, head), f_in, *map(torch.from_numpy, tail), k=32
    )
    _assert_bf16_close(out, _jax_f32(ref), (1, n, 4 * h))


@pytest.mark.parametrize("h,n", [(8, 300), (32, 200)])
def test_pool2_bf16_plain_matches_pallas_kernel(h, n):
    (r, r_j), (g, g_j), head, _, _ = _pool2_args(h, 8, n, h + 1)
    fused = jax.jit(lambda *a: lfa_pallas.attentive_pool2_fused(*a, k=32, interpret=True))
    ref = fused(r_j, g_j, *map(jnp.asarray, head))
    out = lfa_kernels.attentive_pool2(r, g, *map(torch.from_numpy, head), k=32)
    _assert_bf16_close(out, _jax_f32(ref), (1, n, 2 * h))


def test_bf16_constants_round_the_matrices_once():
    """Under bfloat16 I/O the dots' matrices are folded in float32 and
    rounded once (``.astype(io)`` in the JAX wrappers); offsets, scales
    and w9 stay float32."""
    rng = np.random.RandomState(0)
    h = 8
    args = [torch.from_numpy(_rand(rng, *s)) for s in
            [(h,), (h,), (h,), (h,), (2 * h, 2 * h), (2 * h, h), (h,), (h,), (h,),
             (h, h), (h,), (h,), (h,)]]
    c32 = lfa_kernels.round1_constants(*args)
    c16 = lfa_kernels.round1_constants(*args, dtype=BF16)
    for name in c32:
        expect = c32[name].to(BF16).float() if name in ("ws", "wp", "w2") else c32[name]
        assert c16[name].dtype == torch.float32 and torch.equal(c16[name], expect), name


# --- blocks and the whole model ---------------------------------------------------


def _block_pair(n_out, n_in, n=384, seed=0):
    """A JAX bfloat16 LFA block with non-trivial running statistics (its
    float32 twin's init), the port's bfloat16 twin through the weight
    bridge, and shared inputs (the features rounded to bfloat16, as a
    block's input is in the model). Returns the port's bfloat16 output, its
    float32 output (the control), JAX's bfloat16 and JAX's float32 outputs,
    and the port's bfloat16 block."""
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(1, n, 3) * 0.4).astype(np.float32)
    feats = torch.from_numpy(rng.randn(1, n, n_in).astype(np.float32)).to(BF16)
    block32 = jax_rl.LocalFeatureAggregation(n_out, 32, "pallas")
    feats_j = jnp.asarray(feats.float().numpy())
    variables = jax.jit(block32.init)(jax.random.PRNGKey(seed), jnp.asarray(xyz), feats_j)
    stats = jax.tree.map(
        lambda v: v + 0.05 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        variables["batch_stats"],
    )
    variables = {"params": variables["params"], "batch_stats": stats}
    block16 = jax_rl.LocalFeatureAggregation(n_out, 32, "pallas", dtype="bfloat16")
    args = (jnp.asarray(xyz), feats_j.astype(jnp.bfloat16))
    ref16 = np.asarray(_jit_bf16(block16.apply)(variables, *args).astype(jnp.float32), np.float64)
    truth = np.asarray(jax.jit(block32.apply)(variables, *args), np.float64)
    outs = {}
    for dtype in (torch.float32, BF16):  # the bfloat16 block last: returned
        port = port_rl.LocalFeatureAggregation(n_in, n_out, 32, "naive", dtype=dtype)
        port.load_state_dict(from_flax_variables(jax.device_get(variables)))
        port.eval()
        with torch.inference_mode():
            outs[dtype] = port(torch.from_numpy(xyz), feats.to(dtype))
        assert outs[dtype].dtype == dtype
    out16, out32 = (outs[d].float().numpy().astype(np.float64) for d in (BF16, torch.float32))
    return out16, out32, ref16, truth, port


def _assert_rounds_as_jax_bf16(out, out32, ref16, truth):
    """The port's bfloat16 output lies nearer JAX's bfloat16 output than a
    third of JAX's bfloat16 distance from the float32 forward (mean |Δ|),
    and its float32 output does not: a forward that computed in float32 and
    only cast its result would fail."""
    gap = np.mean(np.abs(ref16 - truth))
    ours, control = np.mean(np.abs(out - ref16)), np.mean(np.abs(out32 - ref16))
    assert ours <= gap / 3 < control, (ours, gap, control)


def _assert_tracks_jax_bf16(out, out32, ref16, truth, max_rel):
    """(a) the port's bfloat16 output within ``max_rel`` of the JAX
    package's (relative to max(|f32 truth|, 1), test_lfa_fused.py's scale),
    (b) no less accurate than it against the float32 forward, as
    test_lfa_fused.py's bfloat16 case holds the fused path to the unfused,
    (c) ``_assert_rounds_as_jax_bf16``."""
    scale = np.maximum(np.abs(truth), 1.0)
    assert np.max(np.abs(out - ref16) / scale) < max_rel
    err_port, err_jax = np.mean(np.abs(out - truth)), np.mean(np.abs(ref16 - truth))
    assert err_port <= err_jax * 1.1 + 1e-4, (err_port, err_jax)
    _assert_rounds_as_jax_bf16(out, out32, ref16, truth)


@pytest.mark.parametrize("n_out,n_in", [(16, 8), (64, 32)])
def test_lfa_block_fused_bf16_matches_jax(force_fused, n_out, n_in):
    """The fused levels (half 8 and 32), the JAX side on its Pallas kernels'
    bfloat16 forms in interpret mode. Measured: at most 9.5e-7 / 0 of
    max(|truth|, 1) apart (limit 0.02); mean |Δ| from JAX's bfloat16
    7.8e-11 / 0 against JAX's bfloat16 mean distance from float32 of
    5.33e-4 / 5.01e-4, which the port's float32 output also keeps."""
    out, out32, ref16, truth, port = _block_pair(n_out, n_in)
    assert port.fused()
    _assert_tracks_jax_bf16(out, out32, ref16, truth, 0.02)


def test_lfa_block_unfused_bf16_matches_jax():
    """Half 64 (encoder level 2) runs unfused on both sides: flax's
    bfloat16 Dense, BatchNorm, activations and softmax. Measured: at most
    7.6e-6 of max(|truth|, 1) apart (limit 0.03); mean |Δ| from JAX's
    bfloat16 7.8e-11 against JAX's bfloat16 mean distance from float32 of
    7.0e-4, which the port's float32 output also keeps. (With XLA's
    excess precision on, JAX's own bfloat16 forward lies 3.6e-4 from the
    strict one.)"""
    out, out32, ref16, truth, port = _block_pair(128, 64, seed=1)
    assert not port.fused()
    _assert_tracks_jax_bf16(out, out32, ref16, truth, 0.03)


def _app_inputs(n=2048):
    frame, _ = _make_frame()(np.random.RandomState(0), 0.3, n)
    perm = np.random.RandomState(1).permutation(n)
    return frame[None], perm


@pytest.fixture(scope="module")
def app_logits():
    """The logits (1, 2, 2048) of the whole RandLA-Net at the app widths
    (K=32, decimation 4, layers [16, 64, 128, 256]) with the bundled
    weights on a 2,048-point mock frame: keys (side, dtype), side "jax" (on
    ``knn="pallas"``, its fused levels in interpret mode; bfloat16 compiled
    strict) or "port", dtype "float32" or "bfloat16"."""
    inputs, perm = _app_inputs()
    variables = _flax_variables()
    kwargs = dict(n_classes=2, n_points=2048, layer_sizes=[16, 64, 128, 256], knn="pallas")
    logits = {}
    jax_rl.FORCE_FUSED_LFA_INTERPRET = True
    try:
        for dtype, jit in (("float32", jax.jit), ("bfloat16", _jit_bf16)):
            net = jax_rl.RandLANet(JaxSettings(**kwargs, compute_dtype=dtype))
            logits["jax", dtype] = np.asarray(
                jit(net.apply)(variables, jnp.asarray(inputs), jnp.asarray(perm)), np.float64
            )
            port = Model.load(ARCHIVE, device="cpu", compute_dtype=dtype, n_points=2048)
            with torch.inference_mode():
                out = port.module(torch.from_numpy(inputs), torch.from_numpy(perm))
            assert out.dtype == torch.float32 and out.shape == (1, 2, 2048)
            logits["port", dtype] = out.numpy().astype(np.float64)
    finally:
        jax_rl.FORCE_FUSED_LFA_INTERPRET = False
    return logits


def test_model_bf16_matches_jax_at_app_widths(app_logits):
    """The whole RandLA-Net at the app widths, bfloat16 on both sides
    (``app_logits``). Judged on the logits by
    ``_assert_rounds_as_jax_bf16`` (measured: mean |Δ| from JAX's bfloat16
    1.3e-3, max 0.125; JAX's bfloat16 from float32 1.56e-2, and the port's
    float32 from JAX's bfloat16 as far: the blocks round as JAX's do, and a
    rare one-ulp flip in a kernel carries through the levels), and on the
    confidences: the port's bfloat16 within max 5.5e-5, mean 3.3e-8 of
    JAX's (limits 5e-3 and 1e-5), its mean distance from JAX's float32
    2.0e-7 against JAX's bfloat16's 1.8e-7 (limit 1.1 times JAX's + 1e-4)."""
    logits = app_logits
    _assert_rounds_as_jax_bf16(logits["port", "bfloat16"], logits["port", "float32"],
                               logits["jax", "bfloat16"], logits["jax", "float32"])
    conf = {key: torch.softmax(torch.from_numpy(v), dim=1).numpy() for key, v in logits.items()}
    diff = np.abs(conf["port", "bfloat16"] - conf["jax", "bfloat16"])
    assert diff.max() <= 5e-3 and diff.mean() <= 1e-5, (diff.max(), diff.mean())
    err_port = np.mean(np.abs(conf["port", "bfloat16"] - conf["jax", "float32"]))
    err_jax = np.mean(np.abs(conf["jax", "bfloat16"] - conf["jax", "float32"]))
    assert err_port <= 1.1 * err_jax + 1e-4, (err_port, err_jax)


@pytest.mark.parametrize("other,agrees", [(("jax", "bfloat16"), True),
                                          (("port", "float32"), False)])
def test_bf16_logits_rule_tells_bf16_from_f32(app_logits, other, agrees):
    """``bf16_card_vs_cpu.logits_agree``, the rule that holds the card's
    bfloat16 logits against the CPU's on every frame, on the app-width
    logits of ``app_logits``: JAX's strict bfloat16 logits, which differ
    from the port's only by the order of sums, meet it against the port's
    bfloat16 logits; the port's float32 logits (the control) miss it.
    Measured: 2.0 bfloat16 ulps of the largest |logit| and a mean |Δ| of
    1.7e-4 of the mean |logit| against JAX's bfloat16; 2.4 ulps and 2.0e-3
    against the port's float32."""
    ok, reading = logits_agree(app_logits[other][0], app_logits["port", "bfloat16"][0])
    assert ok == agrees, reading


def test_bf16_dense_copies_are_cast_once_and_follow_the_weights():
    """A Dense's bfloat16 weight and bias are cast on the first eval forward
    and reused by the next; an in-place update or a reload of the float32
    parameters casts them again."""
    inputs, perm = _app_inputs()
    net = Model.load(ARCHIVE, device="cpu", compute_dtype="bfloat16", n_points=2048).module
    linear = net.fc_start

    def run():
        with torch.inference_mode():
            return net(torch.from_numpy(inputs), torch.from_numpy(perm))

    first = run()
    copies = linear.__dict__["_bf16_params"]
    assert torch.equal(run(), first) and linear.__dict__["_bf16_params"] is copies
    with torch.no_grad():
        linear.weight.mul_(2.0)
    changed = run()
    assert torch.equal(linear.__dict__["_bf16_params"][1], linear.weight.to(BF16))
    assert not torch.equal(changed, first)
    net.load_state_dict(Model.load(ARCHIVE, device="cpu").module.state_dict())
    assert torch.equal(run(), first)


def test_knn_indices_equal_under_both_dtypes(monkeypatch):
    """The geometry stays float32, so every level's neighbour search picks
    the same neighbours in bfloat16 as in float32."""
    calls = {"float32": [], "bfloat16": []}
    search = port_rl.knn_presorted
    inputs, perm = _app_inputs()
    for dtype, seen in calls.items():
        def recorded(*args, _seen=seen):
            out = search(*args)
            _seen.append(out[0])
            return out

        monkeypatch.setattr(port_rl, "knn_presorted", recorded)
        model = Model.load(ARCHIVE, device="cpu", compute_dtype=dtype, n_points=2048)
        with torch.inference_mode():
            model.module(torch.from_numpy(inputs), torch.from_numpy(perm))
    assert len(calls["float32"]) == 8  # four self-KNNs, four 1-NN upsamplings
    for a, b in zip(calls["float32"], calls["bfloat16"]):
        assert torch.equal(a, b)


# --- archives and serving -----------------------------------------------


def test_bf16_archive_round_trips_and_serves(tmp_path):
    """``Model.load(..., compute_dtype="bfloat16")`` keeps the float32
    weights; the archive it saves carries the setting (the JAX package
    reads it back as bfloat16), reloads to the same state, a ``Predictor``
    of it answers a frame whose mask agrees with the float32 model's
    (foreground IoU measured 0.977, limit 0.95; the Predictor uploads
    float16, the float32 model float32), and a ``LivePredictor`` of it
    answers a depth frame."""
    f32 = Model.load(ARCHIVE, device="cpu")
    bf = Model.load(ARCHIVE, device="cpu", compute_dtype="bfloat16")
    state, ref = bf.module.state_dict(), f32.module.state_dict()
    assert sorted(state) == sorted(ref)
    assert all(v.dtype == torch.float32 and torch.equal(v, ref[k]) for k, v in state.items())
    path = tmp_path / "bf16"
    bf.save(path)
    again = Model.load(path, device="cpu")
    assert again.settings.compute_dtype == "bfloat16" and again.settings == bf.settings
    assert all(torch.equal(v, state[k]) for k, v in again.module.state_dict().items())
    assert JaxModel.load(path).settings.compute_dtype == "bfloat16"
    cloud, _ = _make_frame()(np.random.RandomState(4), 0.0, 5000)
    np.random.seed(3)
    mask = Predictor(path, device="cpu", warmup_points=5000).predict(cloud)
    np.random.seed(3)
    mask32 = f32.predict_mask(cloud)
    assert mask.shape == (5000,) and mask.dtype == bool
    assert (mask & mask32).sum() / (mask | mask32).sum() >= 0.95
    live = LivePredictor(Model.load(path, device="cpu"), n_display=4096)
    display, live_mask = live.predict_depth(
        pipeline.cloud_to_depth(cloud, pipeline.DepthIntrinsics())
    )
    assert display.shape == (4096, 3) and live_mask.dtype == bool and 0 < live_mask.sum()


def test_evaluate_runs_in_bf16():
    """``Model.evaluate`` (the trainer's 10-seed protocol) runs the served
    forward, so it runs in bfloat16: on two annotated mock clouds its
    metrics lie within 0.02 of the float32 model's (measured: mIoU
    0.98164 against 0.98125, every metric within 8e-4)."""
    make_frame = _make_frame()
    data = []
    for i in range(2):
        cloud, annotation = make_frame(np.random.RandomState(20 + i), 0.3 * i, 2600)
        data.append((cloud, np.zeros((2600, 0)), annotation.astype(np.uint8)))
    names = ["background", "fingerpoint"]
    metrics = {
        dtype: Model.load(ARCHIVE, device="cpu", compute_dtype=dtype, n_points=2048)
        .evaluate(data, names, batch_size=2)
        for dtype in ("float32", "bfloat16")
    }
    assert 0.5 < metrics["float32"]["mIoU"] <= 1.0
    for key, value in metrics["float32"].items():
        assert abs(metrics["bfloat16"][key] - value) <= 0.02, key
