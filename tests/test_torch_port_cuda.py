"""The PyTorch port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip without one. They cover the shapes the
main path does not reach (``chip_smoke.py`` holds the main path's): every
best-list width of the KNN kernel up to k = 128, ragged support tiles,
batches, Morton-sorted self-searches at every level size of the served
paths, tie-heavy grids, unsorted queries and supports, both of the exact
route's forms (the boxes built in shared memory by each block up to 2,048
support points, by a launch of their own above) and supports past 300,000
points, whose boxes a block's shared memory could not hold (against the
streaming kernel, on clustered clouds with duplicates and batches), the
round-1 kernel on
ragged row tiles at every neighbour count it takes, the LFA kernels' reads
of neighbour rows by index (against the gathered rows, bit for bit; batches
of up to 8 clouds; int64 or misshapen indices refused), the window kernel on
Morton-sorted clouds at every window of the recall guard's ladder, the
pool-2 kernels on ragged row tiles and other neighbour counts, the bfloat16
forms of the three LFA kernels (on the tensor cores) on row counts that fill
no warp's or block's tile, batches, every neighbour count and both widths
(and their refusals of mixed dtypes), the 1-NN
kernel on sorted, unsorted, tied, duplicated, flat and far inputs at
supports of 1 to 65,536 points (ordered in shared memory or by its own
launch), the bitonic stage kernel at other shapes and stage counts, the
selection kernel B8 (the n smallest priorities of each row) at shapes the
live and train paths do not reach (65,536 of 262,144, 8 rows of different
valid counts, N = 1, odd N and N beside a tile, n_out = 1 and n_out = N,
n_out beside a multiple of the sort's tile,
rows whose values are all tied or all +inf, negative values, rows past
the staged capacity and n_out = N on them, 70,000 rows in one launch) and
twice on the same input,
under every launch plan forced on one shape (1 to 16 blocks a row, staged
or streamed, the selected keys in shared or global memory; the cluster
barriers' faults show as bits that differ between two runs), and its
refusal of plans it cannot launch; B1's global-memory route (the box
pass, then the walk as a programmatic dependent launch) at 2,049 to
1,048,576 points, its boxes against amin/amax; one small live depth frame
on the card against the CPU, one small train step on the card against the CPU, and the
wrappers' refusals (inputs that require grad among them). The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from recognizer3d_tpu_torch import Model
from recognizer3d_tpu_torch.data import pipeline
from recognizer3d_tpu_torch.models.live import LivePredictor
from recognizer3d_tpu_torch.ops import (_build, bitonic_kernels, knn_kernels, lfa_kernels,
                                        morton, select_kernels)
from recognizer3d_tpu_torch.ops.knn import gather_neighbors, window_starts

ARCHIVE = Path(__file__).resolve().parents[1] / "pretrained" / "mock_fingertip"

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _cloud(seed, b, n, dev, grid=None):
    x = np.random.RandomState(seed).rand(b, n, 3)
    if grid:  # snap to a coarse grid: many exactly tied distances
        x = np.round(x * grid) / grid
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _sorted(x):
    return morton.sort_rows(x, morton.morton_order(x)).contiguous()


@pytest.mark.parametrize(
    "b,n,m,k,grid,layout",
    [
        (1, 2500, 2500, 32, None, "unsorted"),
        (2, 1500, 700, 1, None, "unsorted"),
        (1, 3000, 333, 8, 10, "unsorted"),
        (2, 1025, 64, 33, None, "unsorted"),
        (1, 4100, 100, 64, 20, "unsorted"),
        (1, 700, 90, 100, None, "unsorted"),
        (2, 2049, 50, 128, 8, "unsorted"),
        (1, 40, 40, 40, None, "unsorted"),
        # Morton-sorted self-KNN at the served levels: app and live 2,500,
        # 625, 156 and 39 points (k close to N), approx64k 4,096 and 1,024,
        # and the recall guard's 65,536-point exact fallback
        (1, 2500, None, 32, None, "self"),
        (1, 625, None, 32, None, "self"),
        (1, 156, None, 32, None, "self"),
        (1, 39, None, 32, None, "self"),
        (1, 4096, None, 32, None, "self"),
        (1, 1024, None, 32, None, "self"),
        (1, 65536, None, 32, None, "self"),
        (2, 2500, None, 32, None, "self"),    # a batch
        (1, 3000, None, 32, 8, "self"),       # tie-heavy grids
        (1, 2000, None, 32, 10, "self"),
        (2, 1500, None, 64, 20, "self"),
        (1, 1000, None, 1, 10, "self"),       # every list width
        (1, 1000, None, 8, None, "self"),
        (1, 1000, None, 33, 20, "self"),
        (1, 1000, None, 100, None, "self"),
        (1, 1000, None, 128, 8, "self"),
        (1, 128, None, 128, None, "self"),    # k = N
        (1, 20000, 256, 32, None, "guard"),   # the guard's evenly spaced re-search
        (1, 65536, 256, 32, 20, "guard"),
        (1, 4000, 500, 32, 10, "sorted_support"),  # unsorted queries, sorted support
        (2, 9000, 300, 64, None, "sorted_support"),
        # launches of more than one wave (over 64 queries an SM): two queries
        # a warp, the short last group of an odd M repeating its last query
        (1, 4000, 9001, 128, 8, "sorted_support"),  # the widest list
        (1, 12000, None, 64, 10, "self"),
        (2, 5000, None, 32, None, "self"),    # one wave a batch item, not for the batch
        (3, 3001, None, 100, 20, "self"),     # a batch of odd M, ties
        (1, 320000, 64, 8, None, "unsorted"),  # boxes over a block's shared memory
    ],
)
def test_knn_topk_kernel_matches_plain(dev, b, n, m, k, grid, layout):
    """Bit-identical distances and, the order of ties included, the same
    indices as the plain version's stable sort, for supports and queries
    in any order: unsorted, a Morton-sorted self-search, a Morton-sorted
    support with evenly spaced queries of it (the recall guard) or with
    unsorted queries."""
    s = _cloud(n + k, b, n, dev, grid)
    if layout == "unsorted":
        q = _cloud(m + 7, b, m, dev, grid)
    else:
        s = _sorted(s)
        if layout == "self":
            q = s
        elif layout == "guard":
            q = s[:, torch.from_numpy(np.linspace(0, n - 1, m).astype(np.int64)).to(dev)]
            q = q.contiguous()
        else:
            q = _cloud(m + 7, b, m, dev, grid)
    _build.reset_launches()
    idx, d2 = knn_kernels.knn_topk(s, q, k)
    expected = {"knn_topk": 1}
    if _build.library().r3d_knn_topk_scratch_bytes(b, n):  # the global form's box pass
        expected["knn_topk_boxes"] = 1
    assert _build.LAUNCHES == expected
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, q, k)
    torch.cuda.synchronize()
    assert torch.equal(d2, ref_d)
    assert torch.equal(idx, ref_i)


def _clustered(seed, b, n, dev, grid=None):
    """Gaussian blobs of differing spread, Morton-sorted, every fifth point
    duplicated in place of its neighbour: dense and empty tiles side by side,
    and exact ties."""
    rng = np.random.RandomState(seed)
    centres = rng.rand(b, 24, 1, 3)
    spread = 10.0 ** rng.uniform(-3, -1, size=(b, 24, 1, 1))
    x = (centres + spread * rng.randn(b, 24, -(-n // 24), 3)).reshape(b, -1, 3)[:, :n]
    if grid:
        x = np.round(x * grid) / grid
    x[:, 1::5] = x[:, 0:-1:5][:, : x[:, 1::5].shape[1]]
    return _sorted(torch.tensor(x, dtype=torch.float32, device=dev))


@pytest.mark.parametrize(
    "b,n,grid",
    [
        (2, 310_000, None),  # just past a block's shared memory, a batch
        (1, 400_000, 60),    # heavy ties
        (2, 400_000, None),
    ],
)
def test_knn_topk_past_300000_points_matches_streaming(dev, b, n, grid):
    """Supports whose boxes a block's shared memory could not hold: on
    clustered self-searches with duplicate points, every row bit-equal to the
    streaming kernel (the window route with the whole support as one window),
    indices in order, and sampled rows to the plain version's stable sort."""
    k = 32
    s = _clustered(n + b, b, n, dev, grid)
    _build.reset_launches()
    idx, d2 = knn_kernels.knn_topk(s, s, k)
    assert _build.LAUNCHES == {"knn_topk": 1, "knn_topk_boxes": 1}
    starts = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.reset_launches()
    ref_i, ref_d = knn_kernels.knn_window_topk(s, s, k, starts, n, n)
    assert _build.LAUNCHES == {"knn_topk_stream": 1}
    torch.cuda.synchronize()
    assert torch.equal(d2, ref_d)
    assert torch.equal(idx, ref_i)
    rows = torch.from_numpy(np.random.RandomState(b).choice(n, 2048, replace=False)).to(dev)
    plain_i, plain_d = knn_kernels.knn_topk_plain(s, s[:, rows].contiguous(), k)
    assert torch.equal(d2[:, rows], plain_d)
    assert torch.equal(idx[:, rows], plain_i)


@pytest.mark.parametrize(
    "b,n,m,grid,layout",
    [
        (1, 2500, 61440, None, "unsorted"),  # the app frame's shape
        (2, 1030, 5000, 10, "unsorted"),      # a batch, tie grid
        (1, 1, 300, None, "unsorted"),        # one support point
        (1, 2, 17, None, "unsorted"),
        (1, 37, 1001, 4, "unsorted"),         # odd M, heavy ties
        (2, 2500, 16383, None, "unsorted"),   # the live shape, odd M, a batch
        (1, 3000, 777, 3, "duplicates"),      # every support point twice
        (1, 4096, 16384, None, "sorted"),     # approx64k's decoder, staged
        (1, 4500, 999, 8, "sorted"),          # largest staged grids
        (1, 4700, 999, 8, "sorted"),          # smallest ordered by a launch
        (2, 16384, 65536, None, "sorted"),    # approx64k's last decoder level, a batch
        (1, 16384, 5001, 16, "unsorted"),     # the ordering launch, ties, unsorted
        (1, 65536, 3001, None, "sorted"),     # the route's largest support
        (1, 65536, 2000, 20, "unsorted"),
        (1, 2500, 1000, None, "far"),         # queries far outside the support's box
        (1, 2500, 1000, None, "flat"),        # a flat support: one cell thick
    ],
)
def test_argmin_kernel_matches_plain(dev, b, n, m, grid, layout):
    """The first entry of the stable sort by distance, bit for bit, ties
    included, for supports and queries in any order and at every size the
    kernel takes in shared memory or behind its ordering launch."""
    s = _cloud(n, b, n, dev, grid)
    q = _cloud(m, b, m, dev, grid)
    if layout == "sorted":
        s, q = _sorted(s), _sorted(q)
    elif layout == "duplicates":
        s = torch.cat([s[:, : n // 2], s[:, : n - n // 2].flip(1)], 1).contiguous()
    elif layout == "far":
        q = q * 50 - 25
    elif layout == "flat":
        s[..., 2] = 0.5
    # supports too large to order in each CUDA block's shared memory take
    # the ordering launch, and scratch for it
    ordered = _build.library().r3d_argmin_scratch_bytes(b, n) > 0
    assert ordered == (n > 4500)
    _build.reset_launches()
    idx, d2 = knn_kernels.argmin_1nn(s, q)
    assert _build.LAUNCHES == ({"argmin_1nn": 1, "argmin_1nn_order": 1} if ordered
                               else {"argmin_1nn": 1})
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, q, 1)
    torch.cuda.synchronize()
    assert torch.equal(d2, ref_d)
    assert torch.equal(idx, ref_i)
    assert torch.equal(knn_kernels.argmin_1nn_plain(s, q)[0], ref_i)


@pytest.mark.parametrize(
    "b,n,m,k,w,qb,grid",
    [
        (1, 20000, 20000, 32, 4096, 512, None),  # the encoder shape, both ends clamped
        (1, 9000, 30000, 1, 4096, 512, None),     # the upsample shape (k = 1)
        (2, 5000, 3000, 32, 1500, 128, 12),       # w not a multiple of the tile, ties
        (1, 3000, 3000, 128, 700, 64, 10),        # widest best list, ties
        (1, 3000, 90, 32, 1024, 512, None),       # m < qb: one clamped block
        (2, 2000, 2500, 1, 333, 96, 8),           # k = 1, ties, qb = 3 * 32
        (1, 1000, 1000, 64, 1000, 128, None),     # the window is the whole support
    ],
)
def test_knn_window_kernel_matches_plain(dev, b, n, m, k, w, qb, grid):
    """Bit-identical distances and the same indices, in order, as the
    plain version, on each query block's window."""
    s = _cloud(n + w, b, n, dev, grid)
    q = _cloud(m + k, b, m, dev, grid)
    starts = torch.from_numpy(window_starts(n, m, w, qb)).to(dev)
    idx, d2 = knn_kernels.knn_window_topk(s, q, k, starts, w, qb)
    ref_i, ref_d = knn_kernels.knn_window_topk_plain(s, q, k, starts, w, qb)
    torch.cuda.synchronize()
    assert torch.equal(d2, ref_d)
    assert torch.equal(idx, ref_i)
    lo = starts.long()[torch.arange(m, device=dev) // qb]
    assert bool(((idx >= lo[None, :, None]) & (idx < lo[None, :, None] + w)).all())


@pytest.mark.parametrize(
    "n,w,k,grid",
    [(20000, 4096, 16, None), (20000, 4096, 32, None), (20000, 4096, 64, None),
     (20000, 8192, 16, None), (20000, 8192, 32, None), (20000, 8192, 64, None),
     (40000, 16384, 16, None), (40000, 16384, 32, None), (40000, 16384, 64, None),
     (20000, 8192, 32, 12)],  # the last: a coarse grid, many tied distances
)
def test_knn_window_kernel_on_morton_sorted_clouds(dev, n, w, k, grid):
    """The main path's layout (Morton-sorted self-KNN, query_block 512) at
    every window of the recall guard's ladder: the kernel scans each window
    outward from the query's curve position, out of index order, and must
    still equal the plain version's stable sort, ties included."""
    x = _cloud(w + k, 1, n, dev, grid)
    x = morton.sort_rows(x, morton.morton_order(x)).contiguous()
    starts = torch.from_numpy(window_starts(n, n, w, 512)).to(dev)
    idx, d2 = knn_kernels.knn_window_topk(x, x, k, starts, w, 512)
    ref_i, ref_d = knn_kernels.knn_window_topk_plain(x, x, k, starts, w, 512)
    torch.cuda.synchronize()
    assert torch.equal(d2, ref_d)
    assert torch.equal(idx, ref_i)


def _rand(rng, dev, *shape, scale=0.3, low=None):
    x = rng.uniform(low, 1.5, shape) if low is not None else rng.randn(*shape) * scale
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _neighbors(rng, dev, b, n, k):
    """(b, n, k) int32 indices into each cloud's n rows: most near the
    row's own (as the Morton-sorted KNN's), some anywhere in the cloud,
    with repeats, and rows 0 and n - 1 among every row's."""
    near = np.arange(n)[None, :, None] + rng.randint(-40, 41, (b, n, k))
    far = rng.randint(0, n, (b, n, k))
    nb = np.clip(np.where(rng.rand(b, n, k) < 0.8, near, far), 0, n - 1)
    nb[..., 0], nb[..., -1] = 0, n - 1
    return torch.tensor(nb, dtype=torch.int32, device=dev)


def _round1_args(rng, dev, b, n, h, k):
    """lfa_round1's arguments: the table, the neighbour indices, d2,
    center_term, then the weights."""
    c2 = 2 * h
    return [
        _rand(rng, dev, b, n, c2, scale=0.5), _neighbors(rng, dev, b, n, k),
        _rand(rng, dev, b, n, k, low=0.0) * 0.01, _rand(rng, dev, b, n, h),
        _rand(rng, dev, h), _rand(rng, dev, h), _rand(rng, dev, h, low=0.5), _rand(rng, dev, h),
        _rand(rng, dev, c2, c2), _rand(rng, dev, c2, h), _rand(rng, dev, h),
        _rand(rng, dev, h, low=0.5), _rand(rng, dev, h),
        _rand(rng, dev, h, h), _rand(rng, dev, h), _rand(rng, dev, h, low=0.5), _rand(rng, dev, h),
    ]


def _pool2_args(rng, dev, h, f):
    """attentive_pool2's head weights and the residual's tail (wm, wsh, off)."""
    c2 = 2 * h
    head = [
        _rand(rng, dev, c2, c2), _rand(rng, dev, c2, c2), _rand(rng, dev, c2),
        _rand(rng, dev, c2, low=0.5), _rand(rng, dev, c2),
    ]
    tail = [_rand(rng, dev, c2, 4 * h), _rand(rng, dev, f, 4 * h), _rand(rng, dev, 4 * h)]
    return head, tail


@pytest.mark.parametrize("b,n,h,f", [(1, 2500, 8, 8), (2, 301, 32, 32), (1, 77, 8, 3),
                                     (8, 1001, 8, 8), (8, 77, 32, 32)])
def test_lfa_kernels_match_plain(dev, b, n, h, f):
    """Both fused LFA kernels against their plain versions within 1e-5: the
    same float32 maths, summed in another order; batches of 1 and 8 clouds,
    each row's neighbours indices into its own cloud."""
    rng = np.random.RandomState(n)
    k = 32
    r1 = _round1_args(rng, dev, b, n, h, k)
    nb = r1[1]
    pooled, rpe2 = lfa_kernels.lfa_round1(*r1)
    ref_p, ref_r = lfa_kernels.lfa_round1_plain(
        *r1[:4], lfa_kernels.round1_constants(*r1[4:])
    )
    torch.testing.assert_close(pooled, ref_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(rpe2, ref_r, rtol=0, atol=1e-5)

    table = _rand(rng, dev, b, n, h).abs()
    p2, tail = _pool2_args(rng, dev, h, f)
    f_in = _rand(rng, dev, b, n, f, scale=1.0)
    out = lfa_kernels.attentive_pool2_residual(rpe2, table, nb, *p2, f_in, *tail)
    ref = lfa_kernels.attentive_pool2_residual_plain(
        rpe2, table, nb, f_in, lfa_kernels.pool2_constants(*p2, *tail)
    )
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)

    pooled2 = lfa_kernels.attentive_pool2(rpe2, table, nb, *p2)
    ref2 = lfa_kernels.attentive_pool2_plain(rpe2, table, nb, lfa_kernels.pool2_constants(*p2))
    torch.testing.assert_close(pooled2, ref2, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "b,n,h,k,dtype",
    [(b, n, h, k, dt) for b, n in ((1, 77), (8, 301), (1, 2500)) for h, k in ((8, 32), (32, 32))
     for dt in (torch.float32, torch.bfloat16)]
    + [(3, 41, 8, 128, torch.float32), (3, 41, 8, 128, torch.bfloat16),
       (2, 17, 32, 8, torch.float32), (2, 17, 32, 8, torch.bfloat16)],
)
def test_lfa_kernels_on_indices_equal_the_gathered_rows(dev, b, n, h, k, dtype):
    """The kernels' index reads against the rows ``gather_neighbors``
    gathers: B2, B3 and B5 on (table, indices) equal, bit for bit, the same
    kernels on the gathered rows laid out as a table of N·K rows a cloud
    read in order (indices 0, 1, 2, ...: the layout the kernels streamed
    before they read by index); the same values reach the same tiles. Row
    counts that fill no tile, batches of 1 to 8, repeated indices and rows
    0 and n - 1; both forms."""
    rng = np.random.RandomState(b * n + h + k)
    f = 8
    r1 = _round1_args(rng, dev, b, n, h, k)
    r1[0] = r1[0].to(dtype)
    table, nb = r1[:2]
    flat_nb = torch.arange(n * k, dtype=torch.int32, device=dev).view(1, n, k).expand(b, n, k)
    flat_nb = flat_nb.contiguous()

    def flat(t, idx):  # the gathered rows as a table of N·K rows a cloud
        return gather_neighbors(t, idx).reshape(b, n * k, t.shape[-1]).contiguous()

    pooled, rpe2 = lfa_kernels.lfa_round1(*r1)
    pooled_g, rpe2_g = lfa_kernels.lfa_round1(flat(table, nb), flat_nb, *r1[2:])
    assert torch.equal(pooled, pooled_g) and torch.equal(rpe2, rpe2_g)

    head, tail = _pool2_args(rng, dev, h, f)
    f_in = _rand(rng, dev, b, n, f, scale=1.0).to(dtype)
    g = flat(pooled, nb)
    out = lfa_kernels.attentive_pool2_residual(rpe2, pooled, nb, *head, f_in, *tail)
    out_g = lfa_kernels.attentive_pool2_residual(rpe2, g, flat_nb, *head, f_in, *tail)
    assert torch.equal(out, out_g)
    out2 = lfa_kernels.attentive_pool2(rpe2, pooled, nb, *head)
    assert torch.equal(out2, lfa_kernels.attentive_pool2(rpe2, g, flat_nb, *head))


@pytest.mark.parametrize(
    "n,h,k",
    [(n, h, k) for n in (1, 77, 16387)
     for h, ks in ((8, (8, 16, 32, 64)), (32, (8, 16, 32))) for k in ks]
    + [(2500, 8, 32), (625, 32, 32),  # the main path's levels 0 and 1
       (77, 8, 128), (301, 8, 32)],
)
def test_round1_kernel_on_ragged_tiles(dev, n, h, k):
    """B2 within 1e-5 of its plain version on both outputs, at row counts
    that are no multiple of the kernel's row tile (4 rows at h = 32, 8 at
    h = 8), and at K of one softmax chunk (8, 16) and of several (64, 128)."""
    rng = np.random.RandomState(n + h + k)
    args = _round1_args(rng, dev, 1, n, h, k)
    _build.reset_launches()
    pooled, rpe2 = lfa_kernels.lfa_round1(*args)
    assert _build.LAUNCHES == {"lfa_round1": 1}
    ref_p, ref_r = lfa_kernels.lfa_round1_plain(
        *args[:4], lfa_kernels.round1_constants(*args[4:])
    )
    torch.testing.assert_close(pooled, ref_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(rpe2, ref_r, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "n,h,f,k",
    [(n, h, f, 32) for n in (1, 77, 16387) for h in (8, 32) for f in (3, 8, 32)]
    + [(77, 8, 8, 128), (300, 8, 3, 16), (77, 32, 32, 16), (40, 32, 8, 8)],
)
def test_pool2_kernels_on_ragged_tiles(dev, n, h, f, k):
    """B3 and B5 within 1e-5 of their plain versions at row counts that
    are no multiple of the kernel's row tile (8 rows at h = 32, 16 at
    h = 8), and at K of one softmax chunk (8, 16) and of several (128)."""
    rng = np.random.RandomState(n + h + f + k)
    rpe2 = _rand(rng, dev, 1, n, k * h).abs()
    table = _rand(rng, dev, 1, n, h).abs()
    nb = _neighbors(rng, dev, 1, n, k)
    head, tail = _pool2_args(rng, dev, h, f)
    f_in = _rand(rng, dev, 1, n, f, scale=1.0)
    _build.reset_launches()
    out = lfa_kernels.attentive_pool2_residual(rpe2, table, nb, *head, f_in, *tail)
    pooled = lfa_kernels.attentive_pool2(rpe2, table, nb, *head)
    assert _build.LAUNCHES == {"lfa_pool2_res": 1, "lfa_pool2": 1}
    ref = lfa_kernels.attentive_pool2_residual_plain(
        rpe2, table, nb, f_in, lfa_kernels.pool2_constants(*head, *tail)
    )
    ref_p = lfa_kernels.attentive_pool2_plain(rpe2, table, nb, lfa_kernels.pool2_constants(*head))
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(pooled, ref_p, rtol=0, atol=1e-5)


def _assert_bf16_close(got, ref):
    """The bfloat16 forms against their plain versions (the rule of
    ``tests/test_torch_port_bf16.py``): at least 99.9% of the elements
    within one bfloat16 ulp, |Δ| ≤ 2⁻⁷·|ref| + 1e-6, every element within
    one ulp of itself plus one ulp of its row's largest magnitude, and at
    least 99% bit-identical."""
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    d, r = (got.float() - ref.float()).abs(), ref.float().abs()
    assert bool((d <= 2.0**-7 * (r + r.amax(-1, keepdim=True)) + 1e-6).all())
    assert (d <= 2.0**-7 * r + 1e-6).float().mean().item() >= 0.999
    assert (d == 0).float().mean().item() >= 0.99


@pytest.mark.parametrize(
    "b,n,h,k,f",
    [(b, n, h, k, f) for b, n in ((1, 1), (1, 77), (3, 301), (1, 16387), (8, 301))
     for h, k, f in ((8, 32, 8), (32, 32, 32))]
    + [(1, 77, 8, 8, 8), (2, 300, 8, 16, 6), (1, 77, 8, 64, 8), (1, 41, 8, 128, 8),
       (1, 40, 32, 8, 8), (3, 77, 32, 16, 32)]
    # the tensor-core design's edges: rows that fill no warp's tile of 8
    # (1, 17, 1,001), batches 1 and 3, every K at both h, F = 8 and 32
    + [(b, n, h, k, f) for b, n in ((1, 17), (3, 1001)) for h, ks in ((8, (8, 16, 32, 64)),
                                                                      (32, (8, 16, 32)))
       for k in ks for f in (8, 32)]
    + [(3, 17, 8, 128, 32), (1, 1001, 8, 128, 8), (3, 1, 32, 32, 8), (3, 1, 8, 64, 32)],
)
def test_bf16_lfa_kernels_match_plain(dev, b, n, h, k, f):
    """The bfloat16 forms of B2, B3 and B5 against their plain versions:
    row counts that are no multiple of a warp's tile (8 rows for pool 2 with
    the residual) or of a block's warps, batches (1 to 8 clouds, indices
    into each row's own), h = 8 and 32, K of one softmax chunk (8, 16, 32)
    and of several (64, 128, where the scores are computed again against
    the final maximum), F of one padded k-step (6, 8) and of two (32). Each
    form is launched once, under its own launch count."""
    rng = np.random.RandomState(b + n + h + k + f)
    r1 = _round1_args(rng, dev, b, n, h, k)
    r1[0] = r1[0].to(torch.bfloat16)
    nb = r1[1]
    head, tail = _pool2_args(rng, dev, h, f)
    table = _rand(rng, dev, b, n, h).abs().to(torch.bfloat16)
    f_in = _rand(rng, dev, b, n, f, scale=1.0).to(torch.bfloat16)
    _build.reset_launches()
    pooled, rpe2 = lfa_kernels.lfa_round1(*r1)
    out = lfa_kernels.attentive_pool2_residual(rpe2, table, nb, *head, f_in, *tail)
    out2 = lfa_kernels.attentive_pool2(rpe2, table, nb, *head)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"lfa_round1_bf16": 1, "lfa_pool2_res_bf16": 1, "lfa_pool2_bf16": 1}
    bf16 = torch.bfloat16
    ref_p, ref_r = lfa_kernels.lfa_round1_plain(
        *r1[:4], lfa_kernels.round1_constants(*r1[4:], dtype=bf16)
    )
    _assert_bf16_close(pooled, ref_p)
    _assert_bf16_close(rpe2.reshape(b, n, k, h), ref_r.reshape(b, n, k, h))
    ref = lfa_kernels.attentive_pool2_residual_plain(
        rpe2, table, nb, f_in, lfa_kernels.pool2_constants(*head, *tail, dtype=bf16)
    )
    _assert_bf16_close(out, ref)
    ref2 = lfa_kernels.attentive_pool2_plain(
        rpe2, table, nb, lfa_kernels.pool2_constants(*head, dtype=bf16)
    )
    _assert_bf16_close(out2, ref2)


def test_bf16_lfa_wrappers_refuse_mixed_dtypes(dev):
    """A bfloat16 form takes its rows all bfloat16 (d2 and the centre term
    float32), and an even F; anything else raises and launches nothing."""
    rng = np.random.RandomState(9)
    h, k, n = 8, 32, 40
    r1 = _round1_args(rng, dev, 1, n, h, k)
    r1[0] = r1[0].to(torch.bfloat16)
    head, _ = _pool2_args(rng, dev, h, 8)
    rpe2 = _rand(rng, dev, 1, n, k * h).to(torch.bfloat16)
    table, nb = _rand(rng, dev, 1, n, h), r1[1]
    tail3 = [_rand(rng, dev, 2 * h, 4 * h), _rand(rng, dev, 3, 4 * h), _rand(rng, dev, 4 * h)]
    _build.reset_launches()
    with pytest.raises(TypeError, match="d2: dtype"):
        lfa_kernels.lfa_round1(*r1[:2], r1[2].to(torch.bfloat16), *r1[3:])
    with pytest.raises(TypeError, match="table: dtype"):
        lfa_kernels.attentive_pool2(rpe2, table, nb, *head)
    with pytest.raises(ValueError, match="even"):
        lfa_kernels.attentive_pool2_residual(
            rpe2, table.to(torch.bfloat16), nb, *head,
            _rand(rng, dev, 1, n, 3).to(torch.bfloat16), *tail3,
        )
    assert not _build.LAUNCHES


def _misaligned(t):
    """The same values at an address 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    flat[1:] = t.reshape(-1)
    out = flat[1:].view(t.shape)
    assert out.data_ptr() % 16 == t.element_size() and out.is_contiguous()
    return out


def test_lfa_wrappers_refuse_misaligned_rows(dev):
    """The three LFA kernels copy rows 16 bytes at a time: their wrappers
    refuse a table or rpe2 that does not start on a 16-byte boundary, and
    launch nothing."""
    rng = np.random.RandomState(5)
    h, k, n = 8, 32, 40
    r1 = _round1_args(rng, dev, 1, n, h, k)
    rpe2, table, nb = _rand(rng, dev, 1, n, k * h), _rand(rng, dev, 1, n, h), r1[1]
    head, tail = _pool2_args(rng, dev, h, 8)
    f_in = _rand(rng, dev, 1, n, 8)
    _build.reset_launches()
    with pytest.raises(ValueError, match="table: data not 16-byte aligned"):
        lfa_kernels.lfa_round1(_misaligned(r1[0]), *r1[1:])
    for bad_rpe2, bad_table, name in ((_misaligned(rpe2), table, "rpe2"),
                                      (rpe2, _misaligned(table), "table")):
        with pytest.raises(ValueError, match=f"{name}: data not 16-byte aligned"):
            lfa_kernels.attentive_pool2(bad_rpe2, bad_table, nb, *head)
        with pytest.raises(ValueError, match=f"{name}: data not 16-byte aligned"):
            lfa_kernels.attentive_pool2_residual(bad_rpe2, bad_table, nb, *head, f_in, *tail)
    assert not _build.LAUNCHES


def test_lfa_wrappers_refuse_bad_neighbors(dev):
    """The kernels read int32 indices, one (B, N, K) row a query row: the
    wrappers refuse int64 indices and indices whose shape does not match
    d2's (round 1) or rpe2's (pool 2), and launch nothing."""
    rng = np.random.RandomState(6)
    h, k, n = 8, 32, 40
    r1 = _round1_args(rng, dev, 1, n, h, k)
    nb = r1[1]
    rpe2, table = _rand(rng, dev, 1, n, k * h), _rand(rng, dev, 1, n, h)
    head, tail = _pool2_args(rng, dev, h, 8)
    f_in = _rand(rng, dev, 1, n, 8)
    _build.reset_launches()
    with pytest.raises(TypeError, match="neighbors: dtype"):
        lfa_kernels.lfa_round1(r1[0], nb.long(), *r1[2:])
    with pytest.raises(TypeError, match="neighbors: dtype"):
        lfa_kernels.attentive_pool2_residual(rpe2, table, nb.long(), *head, f_in, *tail)
    with pytest.raises(ValueError, match="d2: shape"):
        lfa_kernels.lfa_round1(r1[0], nb[:, :-1].contiguous(), *r1[2:])
    with pytest.raises(ValueError, match="rpe2: shape"):
        lfa_kernels.attentive_pool2(rpe2, table, nb[:, 1:].contiguous(), *head)
    assert not _build.LAUNCHES


def test_wrappers_count_launches_and_refuse_bad_tensors(dev):
    s = _cloud(0, 1, 200, dev)
    starts = torch.zeros(4, dtype=torch.int32, device=dev)
    _build.reset_launches()
    knn_kernels.knn_topk(s, s, 16)
    knn_kernels.argmin_1nn(s, s)
    knn_kernels.knn_window_topk(s, s, 16, starts, 100, 64)
    counts = {"knn_topk": 1, "argmin_1nn": 1, "knn_window_topk": 1}
    assert _build.LAUNCHES == counts
    with pytest.raises(ValueError, match="contiguous"):
        knn_kernels.knn_topk(s, s[:, ::2], 4)
    with pytest.raises(ValueError):
        knn_kernels.knn_topk(s, s.cpu(), 4)
    with pytest.raises(ValueError):
        knn_kernels.knn_topk(s, s, 129)
    with pytest.raises(ValueError, match="multiple of 8"):
        knn_kernels.knn_window_topk(s, s, 16, starts, 100, 50)
    with pytest.raises(ValueError, match="multiple of 32"):
        knn_kernels.knn_window_topk(s, s, 1, starts[:3], 100, 72)
    with pytest.raises(ValueError, match="starts"):
        knn_kernels.knn_window_topk(s, s, 16, starts.long(), 100, 64)
    with pytest.raises(ValueError):
        knn_kernels.knn_window_topk(s, s, 16, starts, 201, 64)
    assert _build.LAUNCHES == counts


def test_kernels_refuse_inputs_that_require_grad(dev):
    """A kernel has no backward: with grad mode on, a CUDA input that
    requires grad raises instead of cutting the autograd graph; under
    no_grad or inference_mode the same tensors launch."""
    s = _cloud(0, 1, 300, dev).requires_grad_()
    _build.reset_launches()
    for fn in (lambda: knn_kernels.knn_topk(s, s, 16), lambda: knn_kernels.argmin_1nn(s, s)):
        with pytest.raises(RuntimeError, match="requires grad"):
            fn()
        with torch.no_grad():
            fn()
        with torch.inference_mode():
            fn()
    assert _build.LAUNCHES == {"knn_topk": 2, "argmin_1nn": 2}


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One small train step (2 × 512 points, layers [16, 64], K = 16) on the
    card and on the CPU from the same weights, batch, permutation and
    dropout mask: 2 B1 launches (one per encoder level), the loss within
    1e-5 relative, every gradient within 1e-4 of its tensor's largest
    |g| (a Dense bias before a BatchNorm, whose exact gradient is 0, within
    1e-4 of its kernel's), the running statistics within 1e-5 of their
    tensor's largest value."""
    from recognizer3d_tpu_torch import RandLANetSettings
    from recognizer3d_tpu_torch.models.randlanet import bn_absorbed_biases
    from recognizer3d_tpu_torch.training import losses
    from recognizer3d_tpu_torch.training.trainer import make_optimizer, train_step

    settings = RandLANetSettings(n_classes=3, n_points=512, n_neighbors=16,
                                 layer_sizes=[16, 64], knn="naive")
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy(rng.rand(2, 512, 3).astype(np.float32))
    labels = (xyz[..., 0] > 0.6).long() + (xyz[..., 1] > 0.8).long()
    perm = torch.from_numpy(rng.permutation(512))
    keep = torch.from_numpy(rng.rand(2, 512, 32) < 0.5)
    results = {}
    for device in ("cpu", dev):
        model = Model(settings, device=device, seed=3)
        model.module.train()
        opt = make_optimizer(model.module, 1e-2)
        _build.reset_launches()
        loss, _ = train_step(model.module, opt, losses.get_loss("dice"), xyz.to(device),
                             labels.to(device), perm.to(device), keep.to(device))
        if device != "cpu":
            torch.cuda.synchronize()
            assert _build.LAUNCHES == {"knn_topk": 2}
        results[str(device)] = (float(loss), {n: p.grad.cpu() for n, p in
                                              model.module.named_parameters()},
                                {n: b.cpu() for n, b in model.module.named_buffers()})
    (loss_c, g_c, b_c), (loss_g, g_g, b_g) = results["cpu"], results[str(dev)]
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    absorbed = bn_absorbed_biases(g_c)
    for name, ref in g_c.items():
        tol = 1e-4 * float(g_c[absorbed.get(name, name)].abs().max())
        assert float((g_g[name] - ref).abs().max()) <= tol, name
    for name, ref in b_c.items():
        assert float((b_g[name] - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), name


@pytest.mark.parametrize(
    "shape,stages,grid",
    [
        ((3, 5, 64), 7, None),      # the narrowest row, d = 32 reached
        ((1, 7, 256), 2, 4),        # two stages only, ties
        ((2, 3, 1024), 13, None),   # the widest row
        ((4, 512), 0, None),        # no stage: the epilogue alone
        ((33, 128), 6, 2),          # 2-D input, heavy ties
        ((5, 64), 0, None),         # every stage count of a cycle and its rest,
        ((5, 64), 1, 3),            # at the narrowest and the widest row
        ((5, 64), 6, None),
        ((5, 64), 7, 3),
        ((5, 64), 45, None),
        ((3, 1024), 0, None),
        ((3, 1024), 1, None),
        ((3, 1024), 6, 5),
        ((3, 1024), 7, None),
        ((3, 1024), 45, 4),
        ((7, 3, 1024), 45, None),   # rows whose threads span CUDA blocks unevenly
    ],
)
def test_roll_stages_kernel_matches_plain(dev, shape, stages, grid):
    """Bit-identical to the plain version, the duplicated payloads of tied
    values included."""
    x = np.random.RandomState(stages).rand(*shape)
    if grid:
        x = np.round(x * grid) / grid
    x = torch.tensor(x, dtype=torch.float32, device=dev)
    _build.reset_launches()
    out = bitonic_kernels.roll_stages(x, stages)
    assert _build.LAUNCHES == {"roll_stages": 1}
    ref = bitonic_kernels.roll_stages_plain(x, stages)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="contiguous"):
        bitonic_kernels.roll_stages(x.transpose(0, -1).contiguous().transpose(0, -1), 1)
    with pytest.raises(ValueError, match="16-byte aligned"):  # 16-byte loads and stores
        bitonic_kernels.roll_stages(_misaligned(x), 1)


def test_live_frame_on_the_card_matches_the_cpu(dev):
    """One 160×120 depth frame through the live program on the card and on
    the CPU, given the same uniform draw and permutation: equal selections
    and clouds (the dewarp divides by tensors on both), packed xyz within
    one float16 ulp, masks equal away from the threshold."""
    intr = pipeline.DepthIntrinsics(width=160, height=120, fx=115.0, fy=115.0,
                                    cx=80.0, cy=60.0)
    rng = np.random.RandomState(0)
    z = rng.uniform(0.3, 0.6, 40_000).astype(np.float32)
    xy = rng.uniform(-0.6, 0.6, (40_000, 2)).astype(np.float32) * z[:, None]
    depth = pipeline.cloud_to_depth(np.column_stack([xy, z]), intr)
    uniform = torch.rand((1, depth.size), generator=torch.Generator().manual_seed(1))
    perm = torch.from_numpy(rng.permutation(2500).astype(np.int32))
    bits = torch.from_numpy(depth)
    gpu = LivePredictor(Model.load(ARCHIVE, device="cuda"), n_display=4096, intrinsics=intr)
    cpu = LivePredictor(Model.load(ARCHIVE, device="cpu"), n_display=4096, intrinsics=intr)
    cloud = pipeline.depth_to_cloud(bits, intr)
    assert torch.equal(pipeline.depth_to_cloud(bits.to(dev), intr).cpu(), cloud)
    out = gpu.program_fn(bits.to(dev), uniform.to(dev), perm.to(dev), 0.5).cpu().numpy()
    ref = cpu.program_fn(bits, uniform, perm, 0.5).numpy()
    near = (cpu.program_fn(bits, uniform, perm, 0.5 - 1e-4).numpy()[:, 3] > 0) != (
        cpu.program_fn(bits, uniform, perm, 0.5 + 1e-4).numpy()[:, 3] > 0
    )
    np.testing.assert_array_equal(out[:, :3], ref[:, :3])
    np.testing.assert_array_equal((out[:, 3] > 0)[~near], (ref[:, 3] > 0)[~near])


def _select_priorities(seed, b, n, kind):
    """(B, N) float32 priorities: a uniform draw, or one with every value
    tied, rounded to 1/256, with +inf tails (valid counts from n down to
    1 across the rows) or with negative values."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, n)
    if kind == "tied":
        x[:] = 0.25
    elif kind == "all_inf":
        x[:] = np.inf
    elif kind == "rounded":
        x = np.floor(x * 256) / 256
    elif kind == "inf_tails":
        for r, valid in enumerate(np.linspace(n, 1, b).astype(int)):
            x[r, valid:] = np.inf
    elif kind == "signed":
        x = x * 4 - 2
    return torch.tensor(x, dtype=torch.float32)


@pytest.mark.parametrize(
    "b,n,n_out,kind",
    [
        (1, 262_144, 65_536, "uniform"),   # a large n_out on the multi-block route
        (1, 262_144, 65_536, "rounded"),
        (8, 20_000, 2_500, "inf_tails"),   # batched rows of different valid counts
        (8, 5_000, 700, "rounded"),
        (1, 1, 1, "uniform"),              # N = 1
        (3, 4_097, 1, "rounded"),          # n_out = 1, N one past a tile
        (2, 12_345, 12_345, "uniform"),    # n_out = N, N odd
        (1, 4_095, 4_000, "inf_tails"),    # N one short of a compaction tile
        (2, 70_001, 3_333, "tied"),        # every value tied: the lowest indices
        (1, 70_001, 70_001, "all_inf"),
        (2, 30_000, 29_000, "signed"),     # negative values (bits inverted)
        (2, 20_000, 16_384, "rounded"),    # 8 sort tiles of 2,048 keys
        (1, 20_000, 16_385, "rounded"),    # and one key in a ninth
        (2, 9_000, 4_096, "rounded"),      # the most keys sorted in tiles of 512
        (1, 9_000, 4_097, "uniform"),      # one more: tiles of 2,048
        (1, 786_432, 16_384, "rounded"),   # the live shape, every valid value tied
        (1, 786_432, 16_384, "inf_tails"),
        (1, 2_097_152, 16_384, "uniform"),    # past the staged capacity: streamed
        (1, 2_097_152, 2_097_152, "rounded"),  # and the keys in a global scratch
        (2, 262_144, 262_144, "tied"),      # staged, the keys in a global scratch
        (70_000, 100, 10, "rounded"),       # more rows than a grid's y or z dimension takes
    ],
)
def test_select_smallest_kernel_matches_plain(dev, b, n, n_out, kind):
    """B8 against its plain version, the stable sort: the same indices in
    the same order, ties to the lower index; a second launch returns the
    same bits."""
    x = _select_priorities(b * n + n_out, b, n, kind).to(dev)
    _build.reset_launches()
    got = select_kernels.select_smallest(x, n_out)
    again = select_kernels.select_smallest(x, n_out)
    assert _build.LAUNCHES == {"select_smallest": 2}
    ref = select_kernels.select_smallest_plain(x, n_out)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (b, n_out)
    assert torch.equal(got, ref)
    assert torch.equal(again, got)


def test_select_smallest_refuses_on_the_card(dev):
    x = torch.rand(2, 100, device=dev)
    _build.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        select_kernels.select_smallest(torch.rand(100, 2, device=dev).t(), 10)
    with pytest.raises(TypeError):
        select_kernels.select_smallest(x.half(), 10)
    with pytest.raises(ValueError):
        select_kernels.select_smallest(x, 101)
    with pytest.raises(RuntimeError, match="requires grad"):
        select_kernels.select_smallest(x.clone().requires_grad_(), 10)
    with torch.no_grad():
        select_kernels.select_smallest(x.clone().requires_grad_(), 10)
    assert _build.LAUNCHES == {"select_smallest": 1}


def _forms():
    return [(c, st, ks) for c in (1, 2, 4, 8, 16) for st in (True, False) for ks in (True, False)]


@pytest.mark.parametrize("kind", ["rounded", "inf_tails"])
@pytest.mark.parametrize("cluster,staged,keys_shared", _forms())
def test_select_smallest_kernel_on_every_form(dev, monkeypatch, cluster, staged, keys_shared,
                                              kind):
    """B8 under every plan (blocks a row, staged or streamed, keys in shared
    or global memory) forced on 3 rows of 30,001 -> 4,099 (tied values,
    rows of different valid counts, the tie at the threshold split over
    blocks), bit-equal to the stable sort, twice."""
    b, n, n_out = 3, 30_001, 4_099
    plan = select_kernels.plan_for(b, n, n_out, cluster, staged, keys_shared)
    monkeypatch.setattr(select_kernels, "select_plan", lambda *args: plan)
    x = _select_priorities(cluster, b, n, kind).to(dev)
    got = select_kernels.select_smallest(x, n_out)
    again = select_kernels.select_smallest(x, n_out)
    ref = select_kernels.select_smallest_plain(x, n_out)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(again, got)


@pytest.mark.parametrize("plan", [
    select_kernels.SelectPlan(1, True, True, 0, 0),     # 2^21 priorities staged in one block
    select_kernels.SelectPlan(32, False, True, 0, 0),   # more blocks than a cluster takes
    select_kernels.SelectPlan(3, False, True, 0, 0),    # not a power of two
])
def test_select_smallest_refuses_an_unlaunchable_plan(dev, monkeypatch, plan):
    """The kernel refuses a plan it cannot launch and the wrapper raises:
    there is no other route."""
    monkeypatch.setattr(select_kernels, "select_plan", lambda *args: plan)
    x = torch.rand(1, 1 << 21, device=dev)
    with pytest.raises(RuntimeError, match="r3d_select_smallest"):
        select_kernels.select_smallest(x, 16_384)


@pytest.mark.parametrize("b,n", [(1, 2_049), (1, 2_500), (1, 16_384), (1, 262_144),
                                 (1, 1_048_576), (2, 2_049), (3, 5_001)])
def test_knn_global_route_boxes_and_walk(dev, b, n):
    """B1's global-memory form (box pass, then the walk as a programmatic
    dependent launch) on clustered Morton-sorted self-searches with
    duplicates: two launches counted, the indices and distances bit-equal
    to the plain version (on 2,048 seeded rows above 65,536 points) and to
    a second call, the boxes equal to ``amin``/``amax`` over tiles and super
    tiles. Batches of 2,049 and 5,001 points put every cloud but the first
    off a 16-byte boundary (the box pass's scalar loads)."""
    k = 32
    s = _clustered(n + 5, b, n, dev)
    _build.reset_launches()
    idx, d2 = knn_kernels.knn_topk(s, s, k)
    assert _build.LAUNCHES == {"knn_topk": 1, "knn_topk_boxes": 1}
    idx2, d22 = knn_kernels.knn_topk(s, s, k)
    rows = torch.arange(n, device=dev)
    if n > 65_536:
        rows = torch.from_numpy(np.sort(
            np.random.RandomState(n).choice(n, 2048, replace=False))).to(dev)
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, s[:, rows].contiguous(), k)
    torch.cuda.synchronize()
    assert torch.equal(d2[:, rows], ref_d)
    assert torch.equal(idx[:, rows], ref_i)
    assert torch.equal(idx2, idx) and torch.equal(d22, d2)
    assert torch.equal(knn_kernels.cull_boxes(s), knn_kernels.cull_boxes_plain(s))
