"""The port's copies of the JAX package's framework-free code, each against
the module it was copied from on the same seeded input: the counting cascade
(``counting/``, ``native/``), ``export/ply.py``, ``utils/writer.py`` and
the CLI parsers of ``scripts/``."""
import argparse
import json

import numpy as np
import pytest

from fruitnerf_tpu import native as jnative
from fruitnerf_tpu.counting import clustering as jclustering
from fruitnerf_tpu.counting import gridhash as jgridhash
from fruitnerf_tpu.export import ply as jply
from fruitnerf_tpu.scripts import count as jcount
from fruitnerf_tpu.scripts import export as jexport
from fruitnerf_tpu.scripts import orchard_e2e as jorchard
from fruitnerf_tpu.scripts import train as jtrain
from fruitnerf_tpu.utils import writer as jwriter
from fruitnerf_tpu_torch import native
from fruitnerf_tpu_torch.counting import clustering, gridhash
from fruitnerf_tpu_torch.export import ply
from fruitnerf_tpu_torch.scripts import count, export, orchard_e2e, train
from fruitnerf_tpu_torch.utils import writer


def _blobs(num=8, n_per=400, radius=0.05, seed=0):
    """Spherical shells around separated centers plus uniform salt noise."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.6, 0.6, (num, 3))
    d = rng.normal(size=(num, n_per, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = radius * (1.0 + rng.normal(0, 0.04, (num, n_per, 1)))
    shells = (centers[:, None] + d * r).reshape(-1, 3)
    noise = rng.uniform(-0.8, 0.8, (200, 3))
    return np.concatenate([shells, noise]).astype(np.float32), centers


@pytest.mark.parametrize("eps, min_samples", [(0.02, 6), (0.05, 20)])
def test_dbscan_labels_equal_the_jax_packages(eps, min_samples):
    """On a clustered cloud of 3,400 points: the port's native engine gives
    the JAX package's native labels, and its numpy grid engine the JAX
    package's numpy grid labels."""
    pts, _ = _blobs()
    want_native, got_native = jnative.dbscan(pts, eps, min_samples), native.dbscan(pts, eps,
                                                                                   min_samples)
    if want_native is None or got_native is None:
        pytest.skip("g++ could not build the native counting library")
    assert got_native.max() >= 7  # the blobs are found
    np.testing.assert_array_equal(got_native, want_native)
    np.testing.assert_array_equal(gridhash.dbscan_grid(pts, eps, min_samples),
                                  jgridhash.dbscan_grid(pts, eps, min_samples))


def test_native_library_builds_outside_the_source_tree():
    """The port builds its own library under ``_build/native/<hash>/``."""
    if native.load() is None:
        pytest.skip("g++ could not build the native counting library")
    path = native.library_path()
    assert path.exists() and path.parent.parent.name == "native"
    assert path.parent.parent.parent.name == "_build"
    assert native._SO == path and count.native_library() == path


def test_fruit_clustering_counts_equal_the_jax_packages():
    """The whole cascade (outlier removal, downsample, DBSCAN, merge, split,
    prune, GT match) with the apple template on a small cloud."""
    pts, centers = _blobs(num=6, n_per=500, seed=1)
    kw = dict(name="apple_small", template="apple", template_size=1.25,
              remove_outliers_nb_points=20, remove_outliers_radius=0.02, down_sample=0.004,
              eps=0.02, min_samples=8, cluster_merge_distance=0.02, gt_count=6)
    want = jclustering.FruitClustering(jclustering.CountingProfile(
        gt_cluster=centers, **kw)).count(pts)
    got = clustering.FruitClustering(clustering.CountingProfile(
        gt_cluster=centers, **kw)).count(pts)
    assert got.count == want.count == 6
    for k in ("first_stage", "fused", "additional", "pruned"):
        assert getattr(got, k) == getattr(want, k), k
    np.testing.assert_array_equal(got.centers, want.centers)
    assert got.metrics == want.metrics


def test_write_ply_bytes_equal_and_read_ply_round_trips(tmp_path):
    rng = np.random.RandomState(2)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cols = rng.randint(0, 256, (500, 3)).astype(np.uint8)
    ply.write_ply(tmp_path / "port.ply", pts, cols)
    jply.write_ply(tmp_path / "jax.ply", pts, cols)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = ply.read_ply(tmp_path / "port.ply")
    np.testing.assert_array_equal(back["points"], pts)
    np.testing.assert_array_equal(back["colors"], jply.read_ply(tmp_path / "jax.ply")["colors"])


def test_metric_writer_lines_equal_but_the_time(tmp_path, capsys):
    metrics = {"loss": 0.12345678, "psnr": 21.5, "step_name": "x", "n": 3}
    printed = {}
    for mod, name in ((writer, "port"), (jwriter, "jax")):
        w = mod.MetricWriter(tmp_path / f"{name}.jsonl")
        w.write(7, metrics)
        w.write(8, {"eval_psnr": 1.0})
        w.close()
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] and "[step 7] loss=0.1235" in printed["port"]
    lines = {n: [json.loads(x) for x in (tmp_path / f"{n}.jsonl").read_text().splitlines()]
             for n in ("port", "jax")}
    assert len(lines["port"]) == len(lines["jax"]) == 2
    for a, b in zip(lines["port"], lines["jax"]):
        assert a.pop("ts") > 0 and b.pop("ts") > 0
        assert a == b


@pytest.mark.parametrize("port, jax_mod, argv", [
    (train, jtrain, ["--data", "synthetic", "--output-dir", "run", "--max-iters", "3",
                     "--sparsity-loss", "0.005", "--resume"]),
    (export, jexport, ["--load-dir", "run", "--output-dir", "out", "--num-points-per-side",
                       "64", "--bounding-box-min", "-1", "-1", "-0.5"]),
    (count, jcount, ["--cloud", "c.ply", "--profile", "apple", "--sweep"]),
    (orchard_e2e, jorchard, ["--output-dir", "run", "--num-fruits", "12", "--grid-levels", "4",
                             "--camera-elevation", "-0.2", "0.8", "--no-jitter"]),
])
def test_cli_parsers_accept_the_jax_packages_arguments(port, jax_mod, argv):
    """The same arguments parse to the same values; each command also takes
    ``--device``, default ``cuda`` (``count``'s is where the cascade's
    device engine runs)."""
    def parse(mod, args):
        p = argparse.ArgumentParser()
        mod.add_args(p)
        return vars(p.parse_args(args))

    got, want = parse(port, argv), parse(jax_mod, argv)
    assert got.pop("device") == "cuda"
    assert got == want
    assert parse(port, [*argv, "--device", "cpu"])["device"] == "cpu"
    if port is orchard_e2e:
        assert orchard_e2e.cli_overrides(argparse.Namespace(**got)) == jorchard.cli_overrides(
            argparse.Namespace(**want))


def test_orchard_counting_profile_equals_the_jax_packages():
    got = orchard_e2e.counting_profile_for(0.0213, 120)
    want = jorchard.counting_profile_for(0.0213, 120)
    assert vars(got) == vars(want)


def test_semantic_fallback_equals_the_jax_packages(tmp_path):
    cm, sib = tmp_path / "semantic_colormap.ply", tmp_path / "semantic.ply"
    ply.write_ply(cm, np.zeros((0, 3), np.float32))
    ply.write_ply(sib, np.ones((5, 3), np.float32))
    for path in (cm, sib, tmp_path / "missing" / "semantic_colormap.ply"):
        assert count._with_semantic_fallback(str(path)) == jcount._with_semantic_fallback(str(path))
