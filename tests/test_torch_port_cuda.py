"""The PyTorch port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip without one. They cover the shapes the
main path does not reach (``chip_smoke.py`` holds the main path's): every
best-list width of the KNN kernel up to k = 128, ragged support tiles,
batches, the window kernel on Morton-sorted clouds at every window of the
recall guard's ladder, the pool-2 kernels on ragged row tiles and other
neighbour counts, the bitonic stage kernel at other shapes and stage counts, one
small live depth frame on the card against the CPU, and the wrappers'
refusals. The file imports neither JAX nor the JAX package, so it also
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
from recognizer3d_tpu_torch.ops import _build, bitonic_kernels, knn_kernels, lfa_kernels, morton
from recognizer3d_tpu_torch.ops.knn import window_starts

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


@pytest.mark.parametrize(
    "b,n,m,k,grid",
    [
        (1, 2500, 2500, 32, None),
        (2, 1500, 700, 1, None),
        (1, 3000, 333, 8, 10),
        (2, 1025, 64, 33, None),
        (1, 4100, 100, 64, 20),
        (1, 700, 90, 100, None),
        (2, 2049, 50, 128, 8),
        (1, 40, 40, 40, None),
    ],
)
def test_knn_topk_kernel_matches_plain(dev, b, n, m, k, grid):
    """Bit-identical distances and, the order of ties included, the same
    indices as the plain version's stable sort."""
    s = _cloud(n + k, b, n, dev, grid)
    q = _cloud(m + 7, b, m, dev, grid)
    idx, d2 = knn_kernels.knn_topk(s, q, k)
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, q, k)
    torch.cuda.synchronize()
    assert torch.equal(d2, ref_d)
    assert torch.equal(idx, ref_i)


@pytest.mark.parametrize("b,n,m,grid", [(1, 2500, 61440, None), (2, 1030, 5000, 10), (1, 1, 300, None)])
def test_argmin_kernel_matches_plain(dev, b, n, m, grid):
    s = _cloud(n, b, n, dev, grid)
    q = _cloud(m, b, m, dev, grid)
    idx, d2 = knn_kernels.argmin_1nn(s, q)
    ref_i, ref_d = knn_kernels.argmin_1nn_plain(s, q)
    torch.cuda.synchronize()
    assert torch.equal(d2, ref_d)
    assert torch.equal(idx, ref_i)


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


@pytest.mark.parametrize("b,n,h,f", [(1, 2500, 8, 8), (2, 301, 32, 32), (1, 77, 8, 3)])
def test_lfa_kernels_match_plain(dev, b, n, h, f):
    """Both fused LFA kernels against their plain versions within 1e-5: the
    same float32 maths, summed in another order."""
    rng = np.random.RandomState(n)
    k, c2 = 32, 2 * h
    r1 = [
        _rand(rng, dev, b, n, k, c2, scale=0.5), _rand(rng, dev, b, n, k, low=0.0) * 0.01,
        _rand(rng, dev, b, n, h),
        _rand(rng, dev, h), _rand(rng, dev, h), _rand(rng, dev, h, low=0.5), _rand(rng, dev, h),
        _rand(rng, dev, c2, c2), _rand(rng, dev, c2, h), _rand(rng, dev, h),
        _rand(rng, dev, h, low=0.5), _rand(rng, dev, h),
        _rand(rng, dev, h, h), _rand(rng, dev, h), _rand(rng, dev, h, low=0.5), _rand(rng, dev, h),
    ]
    pooled, rpe2 = lfa_kernels.lfa_round1(*r1)
    ref_p, ref_r = lfa_kernels.lfa_round1_plain(
        *r1[:3], lfa_kernels.round1_constants(*r1[3:])
    )
    torch.testing.assert_close(pooled, ref_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(rpe2, ref_r, rtol=0, atol=1e-5)

    g2 = _rand(rng, dev, b, n, k, h).abs()
    p2 = [
        _rand(rng, dev, c2, c2), _rand(rng, dev, c2, c2), _rand(rng, dev, c2),
        _rand(rng, dev, c2, low=0.5), _rand(rng, dev, c2),
    ]
    f_in = _rand(rng, dev, b, n, f, scale=1.0)
    tail = [_rand(rng, dev, c2, 4 * h), _rand(rng, dev, f, 4 * h), _rand(rng, dev, 4 * h)]
    out = lfa_kernels.attentive_pool2_residual(rpe2, g2, *p2, f_in, *tail, k=k)
    ref = lfa_kernels.attentive_pool2_residual_plain(
        rpe2, g2, f_in, lfa_kernels.pool2_constants(*p2, *tail), k
    )
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)

    pooled2 = lfa_kernels.attentive_pool2(rpe2, g2, *p2, k=k)
    ref2 = lfa_kernels.attentive_pool2_plain(rpe2, g2, lfa_kernels.pool2_constants(*p2), k)
    torch.testing.assert_close(pooled2, ref2, rtol=0, atol=1e-5)


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
    c2 = 2 * h
    rpe2 = _rand(rng, dev, 1, n, k * h).abs()
    g2 = _rand(rng, dev, 1, n, k, h).abs()
    head = [
        _rand(rng, dev, c2, c2), _rand(rng, dev, c2, c2), _rand(rng, dev, c2),
        _rand(rng, dev, c2, low=0.5), _rand(rng, dev, c2),
    ]
    f_in = _rand(rng, dev, 1, n, f, scale=1.0)
    tail = [_rand(rng, dev, c2, 4 * h), _rand(rng, dev, f, 4 * h), _rand(rng, dev, 4 * h)]
    _build.reset_launches()
    out = lfa_kernels.attentive_pool2_residual(rpe2, g2, *head, f_in, *tail, k=k)
    pooled = lfa_kernels.attentive_pool2(rpe2, g2, *head, k=k)
    assert _build.LAUNCHES == {"lfa_pool2_res": 1, "lfa_pool2": 1}
    ref = lfa_kernels.attentive_pool2_residual_plain(
        rpe2, g2, f_in, lfa_kernels.pool2_constants(*head, *tail), k
    )
    ref_p = lfa_kernels.attentive_pool2_plain(rpe2, g2, lfa_kernels.pool2_constants(*head), k)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(pooled, ref_p, rtol=0, atol=1e-5)


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


@pytest.mark.parametrize(
    "shape,stages,grid",
    [
        ((3, 5, 64), 7, None),      # the narrowest row, d = 32 reached
        ((1, 7, 256), 2, 4),        # two stages only, ties
        ((2, 3, 1024), 13, None),   # the widest row
        ((4, 512), 0, None),        # no stage: the epilogue alone
        ((33, 128), 6, 2),          # 2-D input, heavy ties
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
