"""The PyTorch port's fused LFA kernels (plain versions) and LFA block
against the JAX package.

The JAX kernels run in Pallas interpret mode on the CPU. Tolerance 1e-5
absolute on outputs of order one: both sides are float32 with the same
folded constants; they differ only in summation order (the JAX kernels sum
over lane-flattened block-diagonal products, the port per channel), which
moves results by a few float32 ulps.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.ops import lfa_pallas
from recognizer3d_tpu_torch.models import large as port_large
from recognizer3d_tpu_torch.models import randlanet as port_rl
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.ops import lfa_kernels
from recognizer3d_tpu_torch.ops.knn import gather_neighbors

ATOL = 1e-5


@pytest.fixture
def force_fused():
    jax_rl.FORCE_FUSED_LFA_INTERPRET = True
    yield
    jax_rl.FORCE_FUSED_LFA_INTERPRET = False


def _rand(rng, *shape, scale=0.3):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _pos(rng, *shape):
    return rng.uniform(0.5, 1.5, shape).astype(np.float32)


def _neighbors(rng, n, k):
    """(1, n, k) int32 indices into n rows: drawn with repeats, rows 0 and
    n - 1 among them."""
    nb = rng.randint(0, n, (1, n, k)).astype(np.int32)
    nb[..., 0], nb[..., -1] = 0, n - 1
    return nb


def _gathered(table, nb):
    """The JAX wrappers' gathered rows: (1, S, C) at (1, N, K) -> (1, N, K, C)."""
    return table[0][nb]


def _round1_args(h, n, k=32, seed=0):
    """lfa_round1's arguments: the table, the neighbour indices, d2, the
    centre term, then the weights."""
    rng = np.random.RandomState(seed)
    c2 = 2 * h
    return [
        _rand(rng, 1, n, c2, scale=0.5),                     # table
        _neighbors(rng, n, k),                               # neighbors
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


@pytest.mark.parametrize("h,n", [(8, 300), (32, 200)])
def test_round1_plain_matches_pallas_kernel(h, n):
    args = _round1_args(h, n)
    pooled_j, rpe2_j = lfa_pallas.lfa_round1_fused(
        jnp.asarray(_gathered(*args[:2])), *[jnp.asarray(a) for a in args[2:]], interpret=True
    )
    pooled_p, rpe2_p = lfa_kernels.lfa_round1(*[torch.from_numpy(a) for a in args])
    assert tuple(rpe2_p.shape) == (1, n, 32 * h)
    np.testing.assert_allclose(pooled_p.numpy(), np.asarray(pooled_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rpe2_p.numpy(), np.asarray(rpe2_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,f,n", [(8, 8, 300), (32, 32, 200)])
def test_pool2_residual_plain_matches_pallas_kernel(h, f, n):
    rng = np.random.RandomState(h + f)
    k, c2 = 32, 2 * h
    args = [
        np.abs(_rand(rng, 1, n, k * h, scale=0.5)),  # rpe2 (post-relu)
        np.abs(_rand(rng, 1, n, h, scale=0.5)),      # table: pooled rows (post-relu)
        _neighbors(rng, n, k),                       # neighbors
        _rand(rng, c2, c2),                          # ws
        _rand(rng, c2, c2), _rand(rng, c2),          # wp, bp
        _pos(rng, c2), _rand(rng, c2),               # sp, op
        _rand(rng, 1, n, f, scale=1.0),              # f_in
        _rand(rng, c2, 4 * h), _rand(rng, f, 4 * h), _rand(rng, 4 * h),  # wm, wsh, off
    ]
    jax_args = [args[0], _gathered(*args[1:3]), *args[3:]]
    out_j = lfa_pallas.attentive_pool2_residual_fused(
        *[jnp.asarray(a) for a in jax_args], k=k, interpret=True
    )
    out_p = lfa_kernels.attentive_pool2_residual(*[torch.from_numpy(a) for a in args])
    assert tuple(out_p.shape) == (1, n, 4 * h)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,n", [(8, 300), (32, 200)])
def test_pool2_plain_matches_pallas_kernel(h, n):
    """Pool 2 without the residual (``_pool2_kernel``)."""
    rng = np.random.RandomState(h + 1)
    k, c2 = 32, 2 * h
    args = [
        np.abs(_rand(rng, 1, n, k * h, scale=0.5)),  # rpe2 (post-relu)
        np.abs(_rand(rng, 1, n, h, scale=0.5)),      # table: pooled rows (post-relu)
        _neighbors(rng, n, k),                       # neighbors
        _rand(rng, c2, c2),                          # ws
        _rand(rng, c2, c2), _rand(rng, c2),          # wp, bp
        _pos(rng, c2), _rand(rng, c2),               # sp, op
    ]
    jax_args = [args[0], _gathered(*args[1:3]), *args[3:]]
    out_j = lfa_pallas.attentive_pool2_fused(
        *[jnp.asarray(a) for a in jax_args], k=k, interpret=True
    )
    out_p = lfa_kernels.attentive_pool2(*[torch.from_numpy(a) for a in args])
    assert tuple(out_p.shape) == (1, n, c2)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), rtol=0, atol=ATOL)


def test_supports_gate_matches_jax():
    for k in (8, 16, 24, 32, 64, 128):
        for half in (4, 8, 16, 32, 64, 128):
            for dt in ("float32", "bfloat16", "float16"):
                assert lfa_kernels.supports(k, half, dt) == lfa_pallas.supports(k, half, dt)


def _block_pair(n_out, n_in, n=384, seed=0):
    """A JAX LFA block with non-trivial running stats, the port's twin
    loaded through the weight bridge, and shared inputs."""
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(1, n, 3) * 0.4).astype(np.float32)
    feats = rng.randn(1, n, n_in).astype(np.float32)
    block = jax_rl.LocalFeatureAggregation(n_out, 32, "pallas")
    variables = jax.jit(block.init)(jax.random.PRNGKey(seed), jnp.asarray(xyz), jnp.asarray(feats))
    stats = jax.tree.map(
        lambda v: v + 0.05 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        variables["batch_stats"],
    )
    variables = {"params": variables["params"], "batch_stats": stats}
    port = port_rl.LocalFeatureAggregation(n_in, n_out, 32, "naive")
    port.load_state_dict(from_flax_variables(jax.device_get(variables)))
    port.eval()
    return block, variables, port, xyz, feats


@pytest.mark.parametrize("n_out,n_in", [(16, 8), (64, 32)])
def test_lfa_block_fused_matches_jax_fused(force_fused, n_out, n_in):
    block, variables, port, xyz, feats = _block_pair(n_out, n_in)
    assert port.fused()
    ref = jax.jit(block.apply)(variables, jnp.asarray(xyz), jnp.asarray(feats))
    with torch.inference_mode():
        out = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_out,n_in", [(16, 8), (128, 64)])
def test_lfa_block_matches_jax_unfused(n_out, n_in):
    """JAX's unfused flax path against the port: at n_out=128 (half 64)
    both run unfused; at n_out=16 the port runs its fused path, so this
    also holds fused against unfused (2e-5: the two formulations order
    their sums differently)."""
    block, variables, port, xyz, feats = _block_pair(n_out, n_in, seed=1)
    assert port.fused() == (n_out == 16)
    ref = jax.jit(block.apply)(variables, jnp.asarray(xyz), jnp.asarray(feats))
    with torch.inference_mode():
        out = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


# --- no neighbour-row gather at a fused level ----------------------------------


class _IndexSelects(torch.overrides.TorchFunctionMode):
    """Records the output shape of every ``index_select`` (the row gather of
    ``gather_neighbors`` and of the large forward) made outside the fused
    LFA wrappers: on the CPU their plain versions gather the rows the
    kernels read by index on the card, so those gathers are not the
    model's."""

    def __init__(self):
        super().__init__()
        self.shapes, self.in_kernel = [], 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.index_select, torch.Tensor.index_select) and not self.in_kernel:
            self.shapes.append(tuple(out.shape))
        return out


def _count_gathers(monkeypatch, forward):
    """(index_select output shapes, gather_neighbors' (B, N, K, C) results
    in the model, the row tables the fused wrappers got) over ``forward()``."""
    mode, gathers, tables = _IndexSelects(), [], []

    def counted(features, neighbors):
        out = gather_neighbors(features, neighbors)
        gathers.append(tuple(out.shape))
        return out

    def kernel(fn, table_at):
        def run(*args, **kwargs):
            tables.append(tuple(args[table_at].shape))
            mode.in_kernel += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.in_kernel -= 1
        return run

    monkeypatch.setattr(port_rl, "gather_neighbors", counted)
    monkeypatch.setattr(lfa_kernels, "lfa_round1", kernel(lfa_kernels.lfa_round1, 0))
    monkeypatch.setattr(lfa_kernels, "attentive_pool2_residual",
                        kernel(lfa_kernels.attentive_pool2_residual, 1))
    with torch.inference_mode(), mode:
        forward()
    return mode.shapes, gathers, tables


def _eval_net(layer_sizes, n, k, decimation, seed=0):
    torch.manual_seed(seed)
    settings = port_rl.RandLANetSettings(
        n_classes=2, n_points=n, n_features=0, n_neighbors=k, decimation=decimation,
        layer_sizes=layer_sizes, knn="naive")
    net = port_rl.RandLANet(settings).eval()
    rng = np.random.RandomState(seed)
    inputs = torch.from_numpy(rng.rand(1, n, 3).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    return net, inputs, perm


def test_model_eval_forward_gathers_no_rows_at_fused_levels(monkeypatch):
    """One eval forward of a 4-level model (K = 16; levels of 512, 256,
    128 and 64 points; half widths 8 and 32 fused, 64 and 128 not): the
    fused levels hand the kernels their (B, N, 2h) and (B, N, h) tables and
    gather no neighbour rows; the unfused levels gather theirs (two a
    level: the (N, K, 2h) table rows, then the pooled rows) and the
    decoder's four 1-NN upsamples theirs."""
    net, inputs, perm = _eval_net([16, 64, 128, 256], 512, 16, 2)
    shapes, gathers, tables = _count_gathers(monkeypatch, lambda: net(inputs, perm))
    assert tables == [(1, 512, 16), (1, 512, 8), (1, 256, 64), (1, 256, 32)]
    assert gathers == [(1, 128, 16, 128), (1, 128, 16, 64), (1, 64, 16, 256), (1, 64, 16, 128),
                       (1, 64, 1, 512), (1, 128, 1, 256), (1, 256, 1, 128), (1, 512, 1, 32)]
    assert shapes == [(b * m * k, c) for b, m, k, c in gathers]


def test_large_forward_gathers_no_rows_at_fused_levels(monkeypatch):
    """``forward_eval_large`` at a fused geometry (K = 16, levels of 512 and
    128 points, half widths 8 and 32): both levels run the kernels on their
    whole tables, and its only row gathers are the two 1-NN upsamples."""
    net, inputs, perm = _eval_net([16, 64], 512, 16, 4)
    shapes, gathers, tables = _count_gathers(
        monkeypatch, lambda: port_large.forward_eval_large(net, inputs, perm, chunk=128))
    assert tables == [(1, 512, 16), (1, 512, 8), (1, 128, 64), (1, 128, 32)]
    assert gathers == []
    assert shapes == [(128, 128), (512, 32)]
