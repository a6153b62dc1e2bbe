"""The PyTorch port's geometry, KNN and upsampling ops against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU; the
JAX Pallas kernels run in interpret mode, as the JAX package's own tests
run them. The port's kernels are CUDA-only, so here their wrappers run the
plain PyTorch versions, which compute distances like the kernels do.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from recognizer3d_tpu.data import preprocessing as jax_pre
from recognizer3d_tpu.ops import knn as jax_knn
from recognizer3d_tpu.ops import knn_cpp as jax_knn_cpp
from recognizer3d_tpu.ops import knn_pallas as jkp
from recognizer3d_tpu.ops import upsample as jax_up
from recognizer3d_tpu_torch.data import preprocessing as port_pre
from recognizer3d_tpu_torch.ops import knn as port_knn
from recognizer3d_tpu_torch.ops import knn_kernels, morton
from recognizer3d_tpu_torch.ops import upsample as port_up
from recognizer3d_tpu_torch.utils import msgpack_lite


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    """Some tests seed or draw from numpy's global RNG (the facade's
    permutation contract); leave it as found for the tests that follow."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _cloud(seed, b, n, scale=1.0):
    return (np.random.RandomState(seed).rand(b, n, 3) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- geometry helpers: exact -------------------------------------------------


@pytest.mark.parametrize("b,n,seed", [(1, 2500, 0), (2, 777, 1), (3, 39, 2)])
def test_morton_codes_orders_inverse_exact(b, n, seed):
    x = _cloud(seed, b, n, scale=0.7) - 0.35
    x[:, : n // 10] = x[:, :1]  # duplicated points: tied codes, stable order
    codes_j = np.asarray(jkp.morton_codes(jnp.asarray(x)))
    codes_p = morton.morton_codes(_t(x)).numpy()
    np.testing.assert_array_equal(codes_p, codes_j)
    order_j = np.asarray(jkp.morton_order(jnp.asarray(x)))
    order_p = morton.morton_order(_t(x)).numpy()
    np.testing.assert_array_equal(order_p, order_j)
    inv_j = np.asarray(jkp.invert_permutation(jnp.asarray(order_j)))
    inv_p = morton.invert_permutation(_t(order_p)).numpy()
    np.testing.assert_array_equal(inv_p, inv_j)
    perm = np.random.RandomState(seed).permutation(n)
    np.testing.assert_array_equal(
        morton.invert_permutation(_t(perm)).numpy(),
        np.asarray(jkp.invert_permutation(jnp.asarray(perm))),
    )


@pytest.mark.parametrize("n,m", [(60000, 2500), (8000, 2500), (1000, 2500), (2500, 2500)])
def test_consistent_sample_indices_exact(n, m):
    np.random.seed(123)
    state = np.random.get_state()[1].copy()
    np.testing.assert_array_equal(
        port_pre.consistent_sample_indices(n, m),
        jax_pre.consistent_sample_indices(n, m),
    )
    # the consistent draw leaves the caller's RNG state untouched
    np.testing.assert_array_equal(np.random.get_state()[1], state)


# --- plain versions of the KNN kernels vs the Pallas kernels -----------------


def _assert_knn_match(idx_p, d2_p, idx_j, d2_j):
    """Index SETS equal per query (slot order within equal-distance groups
    is free) and sorted d2 within 1e-6 (both use direct differences; the
    Pallas merge reports exact f32 per winner)."""
    idx_p = np.sort(idx_p, axis=-1)
    idx_j = np.sort(idx_j, axis=-1)
    np.testing.assert_array_equal(idx_p, idx_j)
    np.testing.assert_allclose(
        np.sort(d2_p, -1), np.sort(d2_j, -1), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize(
    "b,n,m,k,presorted",
    [(1, 1000, 1000, 32, True), (2, 625, 300, 16, False), (1, 156, 156, 32, False)],
)
def test_knn_topk_plain_matches_pallas_kernel(b, n, m, k, presorted):
    """``presorted``: a Morton-sorted self-KNN through
    ``knn_pallas_presorted``, as the encoder levels run it; otherwise
    ``knn_pallas``, which sorts and unsorts around the kernel itself."""
    s = _cloud(10 + n, b, n)
    if presorted:
        s = np.take_along_axis(s, morton.morton_order(_t(s)).numpy()[..., None], 1)
        q = s
        idx_j, d2_j = jkp.knn_pallas_presorted(
            jnp.asarray(s), jnp.asarray(q), k, interpret=True
        )
    else:
        q = _cloud(20 + m, b, m)
        idx_j, d2_j = jkp.knn_pallas(jnp.asarray(s), jnp.asarray(q), k, interpret=True)
    idx_p, d2_p = knn_kernels.knn_topk(_t(s), _t(q), k)
    assert idx_p.dtype == torch.int32 and d2_p.dtype == torch.float32
    assert tuple(idx_p.shape) == (b, m, k)
    _assert_knn_match(idx_p.numpy(), d2_p.numpy(), np.asarray(idx_j), np.asarray(d2_j))
    # nearest first, and the stable order the CUDA kernel reproduces
    assert np.all(np.diff(d2_p.numpy(), axis=-1) >= 0)


@pytest.mark.parametrize("b,n,m", [(1, 900, 1000), (2, 200, 700)])
def test_argmin_plain_matches_pallas_kernel(b, n, m):
    s = _cloud(30 + n, b, n)
    q = _cloud(40 + m, b, m)
    idx_j, d2_j = jkp.argmin_pallas(jnp.asarray(s), jnp.asarray(q), interpret=True)
    idx_p, d2_p = knn_kernels.argmin_1nn(_t(s), _t(q))
    assert tuple(idx_p.shape) == (b, m, 1)
    np.testing.assert_allclose(d2_p.numpy(), np.asarray(d2_j), rtol=0, atol=1e-6)
    # indices equal wherever the nearest distance is untied
    full = knn_kernels._sq_dists(_t(q), _t(s)).numpy()
    second = np.sort(full, axis=-1)[..., 1:2]
    untied = second > d2_p.numpy()
    assert untied.mean() > 0.99
    np.testing.assert_array_equal(idx_p.numpy()[untied], np.asarray(idx_j)[untied])



@pytest.mark.parametrize("b,n", [(1, 2_048), (2, 3_072)])
def test_cull_boxes_plain_matches_the_pallas_tile_boxes(b, n):
    """The global-memory form's boxes (``knn_kernels.cull_boxes_plain``, what
    the box pass is held to on the card) are the TPU kernel's tile boxes
    (``knn_pallas._tile_prep``) over tiles of 32 points, then over super
    tiles of 1,024."""
    x = np.random.RandomState(n).rand(b, n, 3).astype(np.float32)
    got = knn_kernels.cull_boxes_plain(torch.from_numpy(x)).numpy()
    nt = n // 32
    for ts, part in ((32, got[:, :6 * nt]), (1024, got[:, 6 * nt:])):
        ref = np.asarray(jkp._tile_prep(jnp.asarray(x), ts)[0])[:, :6]
        np.testing.assert_array_equal(part.reshape(b, 6, n // ts), ref)


def test_cull_boxes_plain_leaves_out_points_past_the_support():
    """A ragged last tile and super tile box only the points there are."""
    b, n = 2, 2_049
    x = np.random.RandomState(1).rand(b, n, 3).astype(np.float32)
    got = knn_kernels.cull_boxes_plain(torch.from_numpy(x)).numpy()
    nt, ns = 65, 3
    assert got.shape == (b, 6 * (nt + ns))
    tiles, supers = got[:, :6 * nt].reshape(b, 6, nt), got[:, 6 * nt:].reshape(b, 6, ns)
    for t, rows in ((nt - 1, x[:, 2_048:]), (0, x[:, :32])):
        np.testing.assert_array_equal(tiles[:, :3, t], rows.min(1))
        np.testing.assert_array_equal(tiles[:, 3:, t], rows.max(1))
    np.testing.assert_array_equal(supers[:, :3, ns - 1], x[:, 2_048:].min(1))
    np.testing.assert_array_equal(supers[:, 3:, 1], x[:, 1_024:2_048].max(1))


def test_knn_kernel_wrappers_reject_bad_arguments():
    s = _t(_cloud(0, 1, 200))
    with pytest.raises(ValueError):
        knn_kernels.knn_topk(s, s, 129)
    with pytest.raises(ValueError):
        knn_kernels.knn_topk(s[:, :10], s, 11)
    with pytest.raises(TypeError):
        knn_kernels.knn_topk(s.double(), s.double(), 4)
    with pytest.raises(ValueError):
        knn_kernels.argmin_1nn(s, s[0])


# --- the front end -------------------------------------------------------------


@pytest.mark.parametrize(
    "n,m,k,route",
    [
        (2500, 2500, 32, "knn_topk"),      # encoder level 0
        (39, 39, 32, "knn_topk"),          # encoder level 3
        (2500, 61440, 1, "argmin_1nn"),    # final upsample onto the full cloud
        (625, 2500, 1, "knn_argmin"),      # decoder inner upsample
        (9, 39, 1, "knn_argmin"),
        (100, 16384, 1, "argmin_1nn"),
        (70000, 10, 1, "knn_topk"),
        (300, 300, 130, "knn_naive"),
    ],
)
def test_knn_routes_like_the_accelerator(monkeypatch, n, m, k, route):
    calls = []
    for name in ("knn_topk", "argmin_1nn", "knn_argmin", "knn_naive", "knn_tiled"):
        monkeypatch.setattr(
            port_knn, name, lambda *a, _n=name, **kw: calls.append(_n)
        )
    s = torch.zeros(1, n, 3)
    q = torch.zeros(1, m, 3)
    port_knn.knn(s, q, k, "naive")
    port_knn.knn_presorted(s, q, k, "naive")
    assert calls == [route, route]


def test_knn_approximate_and_kdtree_raise():
    """An unknown approach raises. ``"kdtree"`` runs the host KD-tree and
    equals the JAX package's bit for bit
    (tests/test_torch_port_kdtree.py holds it further); ``"approximate"``,
    below the window regime, runs the exact KNN kernel
    (tests/test_torch_port_approx.py holds it against JAX)."""
    s = _t(_cloud(0, 1, 100))
    idx, d2 = port_knn.knn(s, s, 16, "kdtree")
    ref_i, ref_d = jax_knn_cpp.knn_kdtree_host(s.numpy(), s.numpy(), 16)
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    np.testing.assert_array_equal(d2.numpy(), ref_d)
    with pytest.raises(ValueError, match="not understood"):
        port_knn.knn(s, s, 16, "faiss")
    idx, d2 = port_knn.knn(s, s, 16, "approximate")
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, s, 16)
    assert torch.equal(idx, ref_i) and torch.equal(d2, ref_d)


def test_knn_tiled_and_naive_agree_with_the_plain_kernel():
    s = _t(_cloud(5, 2, 700))
    q = _t(_cloud(6, 2, 50))
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, q, 9)
    idx, d2 = port_knn.knn_tiled(s, q, 9, support_tile=64)
    np.testing.assert_array_equal(idx.numpy(), ref_i.numpy())
    np.testing.assert_array_equal(d2.numpy(), ref_d.numpy())
    # the expanded-form copy of knn_naive, against the JAX one: d2 within
    # the ‖q‖²+‖s‖²−2qs cancellation error (~1e-7 at unit coordinates)
    idx_n, d2_n = port_knn.knn_naive(s, q, 9)
    _, d2_jn = jax_knn.knn_naive(jnp.asarray(s.numpy()), jnp.asarray(q.numpy()), 9)
    np.testing.assert_allclose(d2_n.numpy(), np.asarray(d2_jn), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d2_n.numpy(), ref_d.numpy(), rtol=0, atol=1e-6)


def test_gather_neighbors_matches_jax():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 50, 7).astype(np.float32)
    idx = rng.randint(0, 50, (2, 30, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        port_knn.gather_neighbors(_t(feats), _t(idx)).numpy(),
        np.asarray(jax_knn.gather_neighbors(jnp.asarray(feats), jnp.asarray(idx))),
    )


@pytest.mark.parametrize("approach", ["none", "nni", "nna", "idw", "isdw"])
def test_upsample_matches_jax(approach):
    """The JAX side searches with its Pallas kernel (interpret mode), whose
    direct-difference distances match the port's; 1e-5 covers the float32
    weighting arithmetic."""
    rng = np.random.RandomState(7)
    xyz = _cloud(8, 1, 300)
    xyz_up = _cloud(9, 1, 1000)
    feats = rng.rand(1, 300, 2).astype(np.float32)
    ref = jax_up.upsample(
        jnp.asarray(feats), jnp.asarray(xyz), jnp.asarray(xyz_up), approach, "pallas"
    )
    out = port_up.upsample(_t(feats), _t(xyz), _t(xyz_up), approach, "naive")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


# --- the msgpack reader/writer ------------------------------------------------


def test_msgpack_writer_is_read_by_flax_and_back():
    from flax import serialization

    tree = {
        "params": {"a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4)}},
        "ints": [0, 1, -1, 127, 128, -33, 65535, 1 << 40, -(1 << 40)],
        "s": "x" * 40,
        "f": 1.5,
        "none": None,
        "flag": True,
        "blob": b"\x00\x01",
        "i8": np.arange(5, dtype=np.int8),
        "scalar": np.float64(2.5),
    }
    blob = msgpack_lite.packb(tree)
    for restored in (serialization.msgpack_restore(blob), msgpack_lite.msgpack_restore(blob)):
        np.testing.assert_array_equal(restored["params"]["a"]["kernel"], tree["params"]["a"]["kernel"])
        assert list(restored["ints"]) == tree["ints"]
        assert restored["s"] == tree["s"] and restored["f"] == 1.5
        assert restored["none"] is None and restored["flag"] is True
        assert bytes(restored["blob"]) == tree["blob"]
        np.testing.assert_array_equal(restored["i8"], tree["i8"])
        assert float(restored["scalar"]) == 2.5
    # and flax's own encoding reads back through the port's decoder
    flax_blob = serialization.msgpack_serialize({"x": np.ones((2, 2), np.float32), "n": 3})
    back = msgpack_lite.msgpack_restore(flax_blob)
    np.testing.assert_array_equal(back["x"], np.ones((2, 2), np.float32))
    assert back["n"] == 3
