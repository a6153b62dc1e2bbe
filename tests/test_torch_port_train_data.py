"""The port's training data path against the JAX package: the numpy
samplers and augmentation, the host loader, the on-disk dataset with its
split and broadened annotations, and the device-resident sampler.

The host side is numpy on the global RNG in both packages, so under one
seed the outputs must be equal, bit for bit. The device sampler takes its
random draws as arguments: the test rebuilds JAX's draws with
``jax.random`` from the same key splits as the JAX sampler and hands them
to the port.
"""

from datetime import datetime, timedelta

import numpy as np
import pytest

import jax
import torch

from recognizer3d_tpu.data import augmentation as jax_aug
from recognizer3d_tpu.data import dataset as jax_dataset
from recognizer3d_tpu.data import loader as jax_loader
from recognizer3d_tpu.data import preprocessing as jax_pre
from recognizer3d_tpu.data.pipeline import DeviceDatasetCache as JaxDeviceDatasetCache
from recognizer3d_tpu_torch.data import augmentation, dataset, loader, preprocessing
from recognizer3d_tpu_torch.data.pipeline import DeviceDatasetCache, SampleDraws


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _clouds(seed, sizes, n_classes=2):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        xyz = rng.rand(n, 3).astype(np.float32)
        labels = (xyz[:, 0] * n_classes).astype(np.uint8)
        out.append((xyz, np.zeros((n, 0)), labels))
    return out


def _same_draws(fn_port, fn_jax, seed=4):
    np.random.seed(seed)
    got = fn_port()
    after_port = np.random.get_state()[1].copy()
    np.random.seed(seed)
    ref = fn_jax()
    np.testing.assert_array_equal(np.random.get_state()[1], after_port)
    return got, ref


@pytest.mark.parametrize("n,m,consistent", [(1000, 300, False), (200, 500, False),
                                            (1000, 300, True), (200, 500, True)])
def test_sample_points_equal(n, m, consistent):
    """Sub- and upsampling, random and consistent: the same indices and the
    same state of the global RNG afterwards."""
    got, ref = _same_draws(lambda: preprocessing.sample_points(n, m, consistent),
                           lambda: jax_pre.sample_points(n, m, consistent))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", [None, "mean", "max", "stdev", "center"])
def test_normalize_cloud_equal(mode):
    xyz = _clouds(0, [300])[0][0]
    np.testing.assert_array_equal(preprocessing.normalize_cloud(xyz, mode),
                                  jax_pre.normalize_cloud(xyz, mode))


def test_numpy_augmentation_equal():
    """The whole host augmentation and each step, under one seed."""
    xyz = _clouds(1, [500])[0][0].astype(np.float64)
    settings = dict(jitter_variance=0.02, jitter_limit=0.04, scale_limit=0.3, shift_limit=0.2,
                    rotation_angle_variances=(0.1, 0.2, 0.3),
                    rotation_angle_limits=(0.2, 0.3, 0.4))
    got, ref = _same_draws(
        lambda: augmentation.perturbate_point_cloud(
            xyz, augmentation.AugmentationSettings(**settings)),
        lambda: jax_aug.perturbate_point_cloud(xyz, jax_aug.AugmentationSettings(**settings)),
    )
    np.testing.assert_array_equal(got, ref)
    assert augmentation.get_mean_radius(xyz) == jax_aug.get_mean_radius(xyz)


@pytest.mark.parametrize("shuffle,consistent,augment,normalization", [
    (True, False, True, None),      # Model.train's training loader
    (False, True, False, None),     # its validation loader
    (True, False, True, "mean"),
])
def test_host_loader_equal(shuffle, consistent, augment, normalization):
    """get_data_loader over the same samples (one shorter than n_points)
    under one seed: the same batches, indices and RNG state, over two
    epochs; the consistent loader's cache hits give the same batches."""
    data = _clouds(2, [700, 300, 900, 650, 800])
    kwargs = dict(n_sample_points=512, batch_size=2, shuffle=shuffle,
                  consistent_sampling=consistent, normalization=normalization)

    def epochs(mod, aug_mod):
        aug = aug_mod.AugmentationSettings() if augment else None
        dl = mod.get_data_loader(data, augmentation_settings=aug, **kwargs)
        assert len(dl) == 3
        return [batch for _ in range(2) for batch in dl]

    got, ref = _same_draws(lambda: epochs(loader, augmentation),
                           lambda: epochs(jax_loader, jax_aug))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    raw = loader.PointCloudPreprocessor(data, 512).__getitem__(1, preprocess=False)
    np.testing.assert_array_equal(raw[0], data[1][0])


def _write_dataset(root, n_clouds, seed, annotate=(), n_points=600):
    """Clouds with annotation masks: index i gets annotate[i] points (None:
    no annotation file)."""
    rng = np.random.RandomState(seed)
    ds = dataset.Dataset(root)
    t0 = datetime(2026, 1, 1, 12, 0, 0)
    for i in range(n_clouds):
        ts = t0 + timedelta(seconds=i, microseconds=17 * i)
        cloud = (rng.rand(n_points, 3) * 0.1).astype(np.float32)
        ds[ts] = cloud
        count = annotate[i] if i < len(annotate) else 5
        if count is None:
            continue
        mask = np.zeros(n_points, np.uint8)
        mask[rng.choice(n_points, count, replace=False)] = 1
        ds.set_annotation(ts, mask)
    return ds


def test_dataset_and_split_equal(tmp_path):
    """Both packages read the same directory to the same samples (the
    unannotated one skipped), with broadened annotations on both routes
    (5 and 40 annotated points), the same 80/20 splits, and a merged
    dataset of two directories split the same way."""
    _write_dataset(tmp_path / "a", 6, 0, annotate=(5, 40, None, 3, 40, 0))
    _write_dataset(tmp_path / "b", 4, 1, annotate=(40, 5, 5, 2))
    assert dataset.Dataset.timestamp(datetime(2026, 3, 4, 5, 6, 7, 89)) == \
        jax_dataset.Dataset.timestamp(datetime(2026, 3, 4, 5, 6, 7, 89))
    port = [dataset.Dataset(tmp_path / d, broaden_annotations=True) for d in "ab"]
    ref = [jax_dataset.Dataset(tmp_path / d, broaden_annotations=True) for d in "ab"]
    for p, r in zip(port, ref):
        assert len(p) == len(r)
        for i in range(len(p)):
            for a, b in zip(p[i], r[i]):
                np.testing.assert_array_equal(a, b)
    merged_p, merged_r = dataset.DatasetMerged(port), jax_dataset.DatasetMerged(ref)
    assert len(merged_p) == len(merged_r) == 9
    # (a split of a directory with unannotated samples skips past them and
    # can run off its selection, in both packages: the split is taken of
    # the fully annotated directory)
    for (sp, sr) in ((port[1].split(), ref[1].split()), (merged_p.split(), merged_r.split())):
        for half_p, half_r in zip(sp, sr):
            assert half_p._selection == half_r._selection
            for i in range(len(half_p)):
                np.testing.assert_array_equal(half_p[i][2], half_r[i][2])


@pytest.mark.parametrize("n_annotated", [1, 31, 32, 400])
def test_broaden_annotation_equal(n_annotated):
    """Both routes on a dense cloud (many points within a radius of the
    annotated ones): below 32 annotated points the blocked expanded form,
    from 32 on the kd-tree's distance (the JAX package's native kd-tree
    where it is built, its numpy form otherwise). The labels must be equal;
    a point that differs is named with both distances."""
    rng = np.random.RandomState(n_annotated)
    cloud = (rng.rand(20000, 3) * 0.15).astype(np.float32)
    ann = np.zeros(len(cloud), np.uint8)
    ann[rng.choice(len(cloud), n_annotated, replace=False)] = 1
    got = dataset.broaden_annotation(cloud, ann)
    ref = jax_dataset.broaden_annotation(cloud, ann)
    assert got.dtype == ref.dtype == np.uint8
    assert 0 < got.sum() < len(cloud)
    diff = np.flatnonzero(got != ref)
    if len(diff):
        anchors = cloud[ann.astype(bool)].astype(np.float64)
        d2 = ((cloud[diff, None].astype(np.float64) - anchors[None]) ** 2).sum(-1).min(1)
        pytest.fail(f"labels differ at points {diff[:10].tolist()}: float64 squared "
                    f"distances {d2[:10].tolist()} against radius² 1e-4")


# --- the device sampler -------------------------------------------------------------


def _jax_draws(key, ids, cache, n_points, settings):
    """JAX's draws for ``DeviceDatasetCache.sample_batch(key, ids)``, rebuilt
    from the same splits as its ``_sample_one``."""
    n_max = cache._xyz.shape[1]
    keys = jax.random.split(key, len(ids))
    uniform, dup, jit, scale, angles, shift = [], [], [], [], [], []
    for k, i in zip(keys, ids):
        k_sel, k_dup, k_aug = jax.random.split(k, 3)
        uniform.append(jax.random.uniform(k_sel, (n_max,)))
        n_valid = int(np.asarray(cache._valid[i]).sum())
        n_real = max(min(n_valid, n_points), 1)
        dup.append(jax.random.randint(k_dup, (n_points,), 0, n_real))
        if settings is not None:
            k_jit, k_scale, k_rot, k_shift = jax.random.split(k_aug, 4)
            jit.append(jax.random.normal(k_jit, (n_points, 3)))
            scale.append(jax.random.uniform(k_scale, (), minval=1 - settings.scale_limit,
                                            maxval=1 + settings.scale_limit))
            angles.append(jax.random.normal(k_rot, (3,)))
            shift.append(jax.random.uniform(k_shift, (3,), minval=-settings.shift_limit,
                                            maxval=settings.shift_limit))
    t = lambda xs, dtype=torch.float32: torch.tensor(np.stack(jax.device_get(xs)), dtype=dtype)
    aug = None
    if settings is not None:
        aug = augmentation.AugmentationDraws(jitter=t(jit), scale=t(scale), angles=t(angles),
                                             shift=t(shift))
    return SampleDraws(uniform=t(uniform), dup_pos=t(dup, torch.int64), augmentation=aug)


@pytest.mark.parametrize("augment", [False, True])
def test_device_sampler_matches_jax_given_its_draws(augment):
    """The port's DeviceDatasetCache against the JAX one's ``sample_batch``,
    handed JAX's draws, on clouds longer and one shorter (300 points) than
    n_points = 512: without augmentation the same rows (so the same
    indices, duplicates included) and labels, bit for bit; with the app's
    augmentation the points within 1e-6 of the cloud's scale (a float32
    sum of 512 radii and a 3×3 rotation in another order)."""
    data = _clouds(3, [900, 300, 700, 512])
    n_points = 512
    jax_settings = jax_aug.AugmentationSettings() if augment else None
    port_settings = augmentation.AugmentationSettings() if augment else None
    ref_cache = JaxDeviceDatasetCache(data, n_points, augmentation_settings=jax_settings)
    cache = DeviceDatasetCache(data, n_points, augmentation_settings=port_settings,
                               device="cpu")
    for seed, ids in ((0, [1, 0, 3]), (5, [2, 1])):
        key = jax.random.PRNGKey(seed)
        ref_pts, ref_labels = jax.device_get(ref_cache.sample_batch(key, np.asarray(ids)))
        draws = _jax_draws(key, ids, ref_cache, n_points, jax_settings)
        pts, labels = cache.assemble(torch.tensor(ids), draws)
        np.testing.assert_array_equal(labels.numpy(), ref_labels)
        if augment:
            np.testing.assert_allclose(pts.numpy(), ref_pts, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(pts.numpy(), ref_pts)
        short = ids.index(1) if 1 in ids else None
        if short is not None and not augment:  # the duplicates are the cloud's own points
            rows = {tuple(r) for r in data[1][0]}
            assert all(tuple(r) in rows for r in pts[short].numpy())


def test_device_sampler_draws_and_epoch():
    """The generator path: an epoch covers every sample once (the remainder
    batch included), the duplicate positions stay inside each cloud's real
    points, and one seed gives the same batches twice."""
    data = _clouds(4, [900, 300, 700, 512, 650])
    cache = DeviceDatasetCache(data, 512, augmentation_settings=augmentation.AugmentationSettings(),
                               device="cpu")

    def epoch(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return list(cache.epoch_batches(2, gen))

    batches = epoch(3)
    assert [b[0].shape for b in batches] == [(2, 512, 3), (2, 512, 3), (1, 512, 3)]
    assert all(torch.isfinite(b[0]).all() for b in batches)
    for (p1, l1), (p2, l2) in zip(batches, epoch(3)):
        assert torch.equal(p1, p2) and torch.equal(l1, l2)
    draws = cache.draw(torch.tensor([1, 0]))
    assert int(draws.dup_pos[0].max()) < 300 and int(draws.dup_pos[1].max()) < 512
    with pytest.raises(ValueError, match="zero points"):
        DeviceDatasetCache(_clouds(0, [10, 0]), 8, device="cpu")
