"""The port's device DBSCAN engine (``counting/dbscan_device.py``) on the
CPU: exact, so labels, neighbor counts and masks equal the BFS reference
(``dbscan_bfs``), a cKDTree and the JAX package's ``dbscan_device`` on the
random clouds of tests/test_counting.py; cells batched under a tiny pairs
budget give the same answer; and the cascade reaches the engine at 50k
points when the native library fails, on the device its caller names (the
card by default, which raises where there is none)."""
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from fruitnerf_tpu.counting import dbscan_device as jax_engine
from fruitnerf_tpu_torch import native
from fruitnerf_tpu_torch.counting import dbscan as dbscan_mod
from fruitnerf_tpu_torch.counting import dbscan_device as engine
from fruitnerf_tpu_torch.counting import gridhash
from fruitnerf_tpu_torch.counting import pointcloud
from fruitnerf_tpu_torch.counting.clustering import FruitClustering
from fruitnerf_tpu_torch.counting.dbscan import dbscan_bfs
from fruitnerf_tpu_torch.counting.profiles import ALL_PROFILES


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: with six test workers on the
    host, torch's thread pools would oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds():
    """tests/test_counting.py::test_dbscan_engines_agree_with_bfs_reference's
    four clouds, eps and min_samples, drawn in its order."""
    rng = np.random.RandomState(3)
    out = []
    for _ in range(4):
        n = rng.randint(100, 2500)
        pts = (rng.randn(n, 3) * rng.uniform(0.05, 1.5) + rng.randn(3)).astype(np.float32)
        out.append((pts, rng.uniform(0.05, 0.4), rng.randint(2, 20)))
    return out


CLOUDS = _clouds()


def _check_exact(pts, eps, ms, labels, counts, mask):
    """Same noise set and core labels as the BFS reference; counts and
    mask as a cKDTree's."""
    ref = dbscan_bfs(pts, eps, ms)
    counts_ref = cKDTree(pts).query_ball_point(pts, eps, return_length=True, workers=-1)
    core = counts_ref >= ms
    assert ((labels == -1) == (ref == -1)).all()
    assert (labels[core] == ref[core]).all()
    np.testing.assert_array_equal(counts, counts_ref)
    np.testing.assert_array_equal(mask, core)


@pytest.mark.parametrize("trial", range(len(CLOUDS)))
def test_engine_is_exact_and_equals_jax(trial):
    pts, eps, ms = CLOUDS[trial]
    labels = engine.dbscan_device(pts, eps, ms, device="cpu")
    counts = engine.neighbor_counts_device(pts, eps, device="cpu")
    mask = engine.radius_neighbor_mask_device(pts, eps, ms, device="cpu")
    _check_exact(pts, eps, ms, labels, counts, mask)
    np.testing.assert_array_equal(labels, jax_engine.dbscan_device(pts, eps, ms))
    np.testing.assert_array_equal(counts, jax_engine.neighbor_counts_device(pts, eps))
    np.testing.assert_array_equal(mask, jax_engine.radius_neighbor_mask_device(pts, eps, ms))
    assert labels.dtype == np.int32 and counts.dtype == np.int64 and mask.dtype == bool


def test_a_cell_over_the_pairs_budget_splits_the_batches(monkeypatch):
    """Two dense blobs (one cell holds ~60 points, K^2 = 4096 pairs) and
    sparse noise under a budget of 64 pairs: every batch is one cell, and
    the answer is the unbatched one."""
    rng = np.random.RandomState(5)
    eps = 0.1
    pts = np.concatenate([
        rng.rand(60, 3) * 0.02, rng.rand(60, 3) * 0.02 + [0.08, 0.0, 0.0],
        rng.rand(300, 3) * 2.0 - 1.0,
    ]).astype(np.float32)
    whole = engine.dbscan_device(pts, eps, 5, device="cpu")
    monkeypatch.setattr(engine, "PAIRS_BUDGET", 64)
    bucket = engine._bucket(pts, eps)
    assert bucket["k"] ** 2 > engine.PAIRS_BUDGET
    batches = engine._chunked(bucket)
    assert len(batches) == bucket["num_cells"]
    assert all(len({int(c) for _, rows in b for c in rows}) == 1 for b in batches)
    labels = engine.dbscan_device(pts, eps, 5, device="cpu")
    np.testing.assert_array_equal(labels, whole)
    _check_exact(pts, eps, 5, labels, engine.neighbor_counts_device(pts, eps, device="cpu"),
                 engine.radius_neighbor_mask_device(pts, eps, 5, device="cpu"))
    assert len(set(labels[labels >= 0])) >= 1


@pytest.fixture(scope="module")
def large_cloud():
    """50,000 points: 40 blobs of 1,200 and 2,000 of uniform noise."""
    rng = np.random.RandomState(11)
    centres = rng.rand(40, 3) * 4.0
    blobs = (centres[:, None] + rng.randn(40, 1200, 3) * 0.05).reshape(-1, 3)
    return np.concatenate([blobs, rng.rand(2000, 3) * 4.0]).astype(np.float32)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(a[-1] if len(a) > 3 else k.get("device"))
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_the_cascade_reaches_the_device_engine_at_50k_points(monkeypatch, large_cloud):
    """With the native library failing, a 50k-point cloud goes to the device
    engine on the device the caller names (the JAX twin's order: native,
    device, grid), and its answer is the native engine's."""
    eps, ms = 0.02, 10
    assert len(large_cloud) == 50_000
    want_labels = native.dbscan(large_cloud, eps, ms)
    want_mask = native.radius_outlier_mask(large_cloud, eps, ms)
    assert want_labels is not None and want_mask is not None
    monkeypatch.setattr(native, "dbscan", lambda *a: None)
    monkeypatch.setattr(native, "radius_outlier_mask", lambda *a: None)
    db_calls = _spy(monkeypatch, engine, "dbscan_device")
    mask_calls = _spy(monkeypatch, engine, "radius_neighbor_mask_device")
    grid_calls = _spy(monkeypatch, gridhash, "dbscan_grid")
    labels = dbscan_mod.dbscan(large_cloud, eps, ms, device="cpu")
    assert db_calls == ["cpu"] and grid_calls == []
    np.testing.assert_array_equal(labels, want_labels)
    kept = pointcloud.radius_outlier_removal(large_cloud, ms, eps, device="cpu")
    assert mask_calls == ["cpu"]
    np.testing.assert_array_equal(kept, large_cloud[want_mask])
    # below 50k points the grid engine answers
    dbscan_mod.dbscan(large_cloud[:2000], eps, ms, device="cpu")
    assert db_calls == ["cpu"] and len(grid_calls) == 1


def test_the_device_engine_never_drops_to_the_cpu(monkeypatch, large_cloud):
    """The cascade's device defaults to the card; where torch finds none,
    reaching the device engine raises rather than counting on the CPU.
    ``FruitClustering`` passes its device down."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run on it")
    monkeypatch.setattr(native, "dbscan", lambda *a: None)
    monkeypatch.setattr(native, "radius_outlier_mask", lambda *a: None)
    with pytest.raises(RuntimeError, match="finds no CUDA card"):
        dbscan_mod.dbscan(large_cloud, 0.02, 10)
    with pytest.raises(RuntimeError, match="finds no CUDA card"):
        FruitClustering(ALL_PROFILES["apple"]).cluster(large_cloud)
    calls = _spy(monkeypatch, engine, "radius_neighbor_mask_device")
    FruitClustering(ALL_PROFILES["apple"], device="cpu").cluster(large_cloud)
    assert calls == ["cpu"]
