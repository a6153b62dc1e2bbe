"""The PyTorch port's ``knn="approximate"`` path against the JAX package.

On the CPU, JAX's ``lax.approx_min_k`` returns exactly ``lax.top_k``'s
selection, so the JAX window and full-distance searches are exact within
their candidate sets, as the port's are everywhere. The two packages then
differ only in how they compute a distance: JAX in the expanded form
‖q‖² + ‖s‖² − 2q·s, the port's kernels by direct differences. That moves
d2 by ~1e-7 and can reorder near-tied neighbours, so index sets are held
equal on every query whose k-th and (k+1)-th in-window distances differ by
more than 1e-5 relative, and d2 within 1e-5.

The JAX oracles are jitted (one compile instead of op-by-op dispatch).
"""

import importlib.machinery
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from recognizer3d_tpu.data.preprocessing import consistent_sample_indices
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.ops import knn as jax_knn
from recognizer3d_tpu.ops import knn_pallas as jkp
from recognizer3d_tpu_torch import Model
from recognizer3d_tpu_torch.ops import knn as port_knn
from recognizer3d_tpu_torch.ops import knn_kernels, morton

ROOT = Path(__file__).resolve().parents[1]
ARCHIVE = ROOT / "pretrained" / "mock_fingertip"


@pytest.fixture(autouse=True)
def _isolate_global_state():
    """Leave numpy's global RNG and both packages' session recall guards
    as found (the guard state is process-global in both)."""
    state = np.random.get_state()
    jax_knn.reset_window_guard()
    port_knn.reset_window_guard()
    yield
    np.random.set_state(state)
    jax_knn.reset_window_guard()
    port_knn.reset_window_guard()


def _cloud(seed, n, scale=1.0):
    return (np.random.RandomState(seed).rand(1, n, 3) * scale).astype(np.float32)


def _sorted(x):
    order = morton.morton_order(torch.from_numpy(x))
    return morton.sort_rows(torch.from_numpy(x), order).numpy()


def _jax_window(s, q, k, w, qb, presorted):
    def search(a, b):
        return jax_knn.knn_window(
            a, b, k, window_points=w, query_block=qb, presorted=presorted
        )

    if q is s:  # a self-search: the JAX function sees one array twice
        return tuple(map(np.asarray, jax.jit(lambda a: search(a, a))(jnp.asarray(s))))
    return tuple(map(np.asarray, jax.jit(search)(jnp.asarray(s), jnp.asarray(q))))


def _separated(d2_next, d2_k):
    """Queries whose k-th and (k+1)-th candidate distances differ by more
    than 1e-5 relative: there the selected set is not a near-tie."""
    return d2_next > d2_k * (1.0 + 1e-5) + 1e-12


def _assert_sets_match(idx_p, d2_p, idx_j, d2_j, separated):
    np.testing.assert_allclose(d2_p, d2_j, rtol=0, atol=1e-5)
    assert separated.mean() > 0.9
    np.testing.assert_array_equal(
        np.sort(idx_p, -1)[separated], np.sort(idx_j, -1)[separated]
    )


# --- the window search ----------------------------------------------------------


@pytest.mark.parametrize(
    "n,m,k,w,qb,presorted,self_knn",
    [
        (3000, 3000, 32, 512, 128, True, True),    # encoder level, sorted domain
        (3000, 3000, 32, 512, 128, False, True),   # self, sorts itself
        (3000, 7000, 1, 512, 128, False, False),   # upsample onto a bigger cloud
        (3000, 1000, 32, 512, 128, True, False),   # M != N, presorted
        (3000, 1000, 1, 512, 128, True, False),
        (3000, 70, 8, 512, 128, False, False),     # m < qb
        (3000, 1300, 32, 640, 128, False, False),  # m not a multiple of qb
    ],
)
def test_knn_window_matches_jax(n, m, k, w, qb, presorted, self_knn):
    s = _cloud(n + k, n)
    q = s if self_knn else _cloud(m + 1, m, scale=0.9) + 0.05
    if presorted:
        s = _sorted(s)
        q = s if self_knn else _sorted(q)
    idx_j, d2_j = _jax_window(s, q, k, w, qb, presorted)
    st = torch.from_numpy(s)
    qt = st if self_knn else torch.from_numpy(q)
    idx_p, d2_p = port_knn.knn_window(
        st, qt, k, window_points=w, query_block=qb, presorted=presorted
    )
    assert idx_p.dtype == torch.int32 and tuple(idx_p.shape) == (1, m, k)
    # the (k+1)-th in-window distance of every query, in the port's order
    s_sorted, q_sorted = (s, q) if presorted else (_sorted(s), _sorted(q))
    starts = torch.from_numpy(port_knn.window_starts(n, m, w, qb))
    _, d2_next = knn_kernels.knn_window_topk_plain(
        torch.from_numpy(s_sorted), torch.from_numpy(q_sorted), k + 1, starts, w, qb
    )
    separated = _separated(d2_next[0, :, k].numpy(), d2_next[0, :, k - 1].numpy())
    if not presorted:
        inv = morton.invert_permutation(morton.morton_order(torch.from_numpy(q)))[0]
        separated = separated[inv.numpy()]
    _assert_sets_match(idx_p.numpy()[0], d2_p.numpy()[0], idx_j[0], d2_j[0], separated)


@pytest.mark.parametrize(
    "n,m,qb",
    [
        (3000, 3000, 64),    # both ends clamped: first and last windows
        (3000, 300, 128),    # m not a multiple of qb, the last block clamped
        (3000, 100, 128),    # m < qb: one block, centre clamped to the queries
        (5000, 9000, 256),   # more queries than support points
    ],
)
def test_window_starts_equal_jax(n, m, qb):
    """With k = w every window point is selected, so each query block's
    smallest index is its window start, in both packages."""
    w = k = 128
    s = _sorted(_cloud(n, n))
    q = _sorted(_cloud(m + 3, m))
    idx_j, _ = _jax_window(s, q, k, w, qb, True)
    idx_p, _ = port_knn.knn_window(
        torch.from_numpy(s), torch.from_numpy(q), k, window_points=w,
        query_block=qb, presorted=True,
    )
    starts = port_knn.window_starts(n, m, w, qb)
    assert starts.dtype == np.int32 and starts.min() >= 0 and starts.max() <= n - w
    if m == n:
        assert starts[0] == 0 and starts[-1] == n - w
    blocks = np.arange(m) // qb
    np.testing.assert_array_equal(idx_j[0].min(-1), starts[blocks])
    np.testing.assert_array_equal(idx_p.numpy()[0].min(-1), starts[blocks])
    np.testing.assert_array_equal(np.sort(idx_p.numpy(), -1), np.sort(idx_j, -1))


@pytest.mark.parametrize("n,m,k", [(4096, 4096, 32), (2000, 500, 16), (3000, 50, 1)])
def test_knn_approximate_matches_jax(n, m, k):
    s = _cloud(n, n)
    q = s if m == n else _cloud(m, m)
    idx_j, d2_j = map(
        np.asarray,
        jax.jit(lambda a, b: jax_knn.knn_approximate(a, b, k))(jnp.asarray(s), jnp.asarray(q)),
    )
    idx_p, d2_p = port_knn.knn_approximate(torch.from_numpy(s), torch.from_numpy(q), k)
    _, d2_next = knn_kernels.knn_topk_plain(torch.from_numpy(s), torch.from_numpy(q), k + 1)
    separated = _separated(d2_next[0, :, k].numpy(), d2_next[0, :, k - 1].numpy())
    _assert_sets_match(idx_p.numpy()[0], d2_p.numpy()[0], idx_j[0], d2_j[0], separated)


# --- routing ----------------------------------------------------------------------

# the 64k-point approximate path: (N, M, k, presorted) -> route
_PATH_CALLS = [
    ((65536, 65536, 32, True), ("knn_window", True)),      # encoder L0
    ((16384, 16384, 32, True), ("knn_window", True)),      # encoder L1
    ((4096, 4096, 32, True), ("knn_approximate", None)),   # encoder L2
    ((1024, 1024, 32, True), ("knn_approximate", None)),   # encoder L3
    ((256, 1024, 1, True), ("knn_argmin", None)),          # decoder upsamples
    ((1024, 4096, 1, True), ("knn_argmin", None)),
    ((4096, 16384, 1, True), ("argmin_1nn", None)),
    ((16384, 65536, 1, True), ("argmin_1nn", None)),
    ((65536, 163840, 1, False), ("knn_window", False)),    # final upsample
    ((40000, 100, 8, False), ("knn_approximate", None)),   # M << N: full distance
    ((13000, 4000, 32, False), ("knn_approximate", None)), # N·M below 64M
]


def _record_routes(monkeypatch, exact_fallback: bool):
    """Replace the leaf searches of both packages with recorders. The JAX
    side takes its accelerator route (``_on_tpu``), as on the TPU."""
    calls = {"jax": [], "port": []}

    def rec(side, name):
        def fn(support, query, *args, presorted=False, **kwargs):
            calls[side].append((name, presorted if name == "knn_window" else None))
        return fn

    monkeypatch.setattr(jax_knn, "_on_tpu", lambda: True)
    for name in ("knn_window", "knn_approximate", "knn_argmin"):
        monkeypatch.setattr(jax_knn, name, rec("jax", name))
    for name, port_name in (
        ("argmin_pallas", "argmin_1nn"), ("argmin_pallas_presorted", "argmin_1nn"),
        ("knn_pallas", "knn_topk"), ("knn_pallas_presorted", "knn_topk"),
    ):
        monkeypatch.setattr(jkp, name, rec("jax", port_name))
    for name in ("knn_window", "knn_approximate", "knn_argmin", "argmin_1nn", "knn_topk"):
        monkeypatch.setattr(port_knn, name, rec("port", name))
    monkeypatch.setitem(jax_knn._session_guard, "exact_fallback", exact_fallback)
    monkeypatch.setitem(port_knn._session_guard, "exact_fallback", exact_fallback)
    return calls


@pytest.mark.parametrize("exact_fallback", [False, True])
def test_approximate_routes_like_jax(monkeypatch, exact_fallback):
    """Both dispatchers at every search of the 64k-point path, and with the
    guard's exact fallback engaged (then the window searches take the
    exact kernel). The clouds are zeros: the recorders never compute."""
    calls = _record_routes(monkeypatch, exact_fallback)
    for (n, m, k, presorted), route in _PATH_CALLS:
        jfn = jax_knn.knn_presorted if presorted else jax_knn.knn
        pfn = port_knn.knn_presorted if presorted else port_knn.knn
        jfn(np.zeros((1, n, 3), np.float32), np.zeros((1, m, 3), np.float32), k, "approximate")
        pfn(torch.zeros(1, n, 3), torch.zeros(1, m, 3), k, "approximate")
        if exact_fallback and route[0] == "knn_window":
            route = ("knn_topk" if k > 1 else "argmin_1nn", None)
        assert calls["port"][-1] == route, (n, m, k)
        # the JAX accelerator route names the Pallas kernel the port replaced
        assert calls["jax"][-1] == calls["port"][-1], (n, m, k)
    assert len(calls["jax"]) == len(calls["port"]) == len(_PATH_CALLS)


# --- recall and the session guard -----------------------------------------------


def _gaussian(seed, n):
    return (np.random.RandomState(seed).randn(n, 3) * 0.2).astype(np.float32)


def test_sampled_recall_matches_jax():
    x = _gaussian(0, 12800)[None]
    w, k = 256, 16
    result_j = jax.jit(lambda a: jax_knn.knn_window(a, a, k, window_points=w))(jnp.asarray(x))
    r_j = float(jax.jit(lambda a, r: jax_knn.sampled_recall(a, a, k, r))(jnp.asarray(x), result_j))
    xt = torch.from_numpy(x)
    r_p = float(port_knn.sampled_recall(xt, xt, k, port_knn.knn_window(xt, xt, k, window_points=w)))
    assert 0.2 < r_p < 0.9  # a narrow window misses neighbours
    assert abs(r_p - r_j) <= 2 / 256
    # an exact result has recall 1
    assert float(port_knn.sampled_recall(xt, xt, k, port_knn.knn(xt, xt, k, "naive"))) == 1.0
    assert port_knn.measure_recall(xt, xt, k, "naive") == 1.0


@pytest.mark.parametrize("m,higher", [(2500, 0), (65_536, 0), (163_840, 1)])
def test_recall_sample_positions_against_jax(m, higher):
    """JAX's positions as its ``sampled_recall`` computes them (float32
    ``linspace``, truncated) against the port's float64 ones: equal at the
    sizes the recall guard probes, and at M = 163,840 (the approx64k
    frame's final upsample) JAX's is one higher wherever they differ."""
    ref = np.asarray(jnp.linspace(0, m - 1, 256).astype(jnp.int32)).astype(np.int64)
    diff = ref - port_knn.recall_sample_positions(m)
    assert int((diff != 0).sum()) == higher
    assert set(diff[diff != 0].tolist()) <= {1}


@pytest.mark.parametrize(
    "ladder,target",
    [
        ((256, 1024, 8192), 0.95),  # widens past the first rungs
        ((128, 256), 1.01),         # misses everywhere: exact fallback
    ],
)
def test_recall_guard_matches_jax(ladder, target):
    cloud = _gaussian(1, 12800)
    ref = jax_knn.ensure_window_recall(cloud, 16, target=target, ladder=ladder)
    got = port_knn.ensure_window_recall(cloud, 16, target=target, ladder=ladder, device="cpu")
    assert got["active"] and ref["active"]
    assert got["window_points"] == ref["window_points"]
    assert got["exact_fallback"] == ref["exact_fallback"]
    assert got["widened"] == ref["widened"]
    assert abs(got["recall"] - ref["recall"]) <= 2 / 256
    assert port_knn.session_window_points() == jax_knn.session_window_points()
    assert port_knn.session_exact_fallback() == jax_knn.session_exact_fallback()
    if target > 1:
        assert got["exact_fallback"]
        s = torch.from_numpy(cloud[None])
        # the fallback routes the window regime to the exact kernel
        idx, _ = port_knn.knn(s, s, 16, "approximate")
        ref_i, _ = knn_kernels.knn_topk_plain(s, s, 16)
        assert torch.equal(idx, ref_i)
    else:
        assert got["widened"] and got["window_points"] > ladder[0]
    port_knn.reset_window_guard()
    assert port_knn.session_window_points() == 4096
    assert not port_knn.session_exact_fallback()


def test_recall_guard_is_a_no_op_below_the_window_regime():
    got = port_knn.ensure_window_recall(_gaussian(2, 5000), 16, target=1.01, device="cpu")
    assert got == {
        "active": False, "recall": 1.0, "window_points": 4096,
        "exact_fallback": False, "widened": False,
    }
    assert not port_knn.window_regime_active(12288)
    assert port_knn.window_regime_active(12289)
    for n in (5000, 12288, 12289, 65536):
        assert port_knn.window_regime_active(n) == jax_knn.window_regime_active(n)


def test_recall_telemetry_logs_a_warning(monkeypatch, caplog):
    monkeypatch.setenv("RECOGNIZER3D_KNN_RECALL", "1")
    x = torch.from_numpy(_gaussian(3, 12800)[None])
    with caplog.at_level("WARNING", logger="knn"):
        port_knn.knn_presorted(x, x, 8, "approximate")
    assert "approximate-KNN recall@8 [window/presorted N=12800 M=12800]" in caplog.text


# --- the slice --------------------------------------------------------------------


def _make_frame():
    loader = importlib.machinery.SourceFileLoader(
        "make_mock_data", str(ROOT / "bin" / "make_mock_data")
    )
    spec = importlib.util.spec_from_loader("make_mock_data", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod.make_frame


def _direct_sq_dists(query, support):
    d = query[:, :, None, :] - support[:, None, :, :]
    d = d * d
    return (d[..., 0] + d[..., 1]) + d[..., 2]


def test_approximate_slice_matches_jax_at_16k(monkeypatch):
    """``knn="approximate"`` at n_points = 16,384, the smallest size whose
    level 0 runs the Morton window, with the bundled weights, on a seeded
    20,000-point mock frame: logits within 1e-4 and the mask equal to the
    JAX confidences thresholded, away from the threshold.

    The JAX side's dispatchers get the port's direct-difference distances
    (the distance formula of the Pallas kernels, which its TPU route uses
    for the exact search): with JAX's own expanded form, near-tied
    neighbours flip and the logits of a frame move by up to 0.22, with the
    masks still equal. The routing, window starts and selection stay the
    JAX package's. Exact float32 ties at the k-th place remain: the port
    keeps the lower index, XLA's CPU top-k may not. The frame of seed 4
    has none at any level (seed 3's has one at level 0, which moves one
    logit by 3.8e-4).
    """
    monkeypatch.setattr(jax_knn, "_pairwise_sq_dists", _direct_sq_dists)
    n_points = 16384
    cloud, _ = _make_frame()(np.random.RandomState(4), 1.1, 20000)
    jax_model = JaxModel.load(ARCHIVE, knn="approximate", n_points=n_points)
    port = Model.load(ARCHIVE, device="cpu", knn="approximate", n_points=n_points)
    assert port.settings.knn == "approximate" and port.settings.n_points == n_points

    # what the JAX predict computes, one jitted forward: consistent
    # subsample -> forward -> softmax -> 1-NN upsample onto the full cloud
    idx = consistent_sample_indices(len(cloud), n_points)
    sampled = cloud[idx][None]
    np.random.seed(11)
    perm = np.random.permutation(n_points)
    logits_j = np.asarray(
        jax.jit(jax_model._module.apply)(jax_model.variables, jnp.asarray(sampled), perm)
    )
    conf_j = np.asarray(jax_model.upsample(logits_j, sampled, cloud[None]))[0]
    guard_j = jax_knn.ensure_window_recall(sampled[0], 32)

    with torch.inference_mode():
        logits_p = port.module(torch.from_numpy(sampled), torch.from_numpy(perm)).numpy()
    np.testing.assert_allclose(logits_p, logits_j, rtol=0, atol=1e-4)

    np.random.seed(11)
    mask = port.predict_mask(cloud, 0.5)  # runs the port's guard first
    guard_p = port.recall_guard_result
    assert guard_p["active"] and guard_p["window_points"] == guard_j["window_points"]
    assert guard_p["exact_fallback"] == guard_j["exact_fallback"] is False
    assert abs(guard_p["recall"] - guard_j["recall"]) <= 2 / 256
    near = np.abs(conf_j[1] - 0.5) <= 1e-4
    assert mask.shape == (20000,) and mask.dtype == bool
    np.testing.assert_array_equal(mask[~near], (conf_j[1] > 0.5)[~near])
    assert 0 < mask.sum() < 20000
