"""The port's export path against the JAX package's on the same (bridged)
parameters, float32 compute on both sides (the JAX grid runs its Pallas
kernel in interpret mode): the AABB normalization, the export forward, and
``sample_volume``'s three clouds, which must hold the same probes up to
counted threshold flips."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.core.math import normalize_aabb_to_unit as jax_normalize
from fruitnerf_tpu.core.rays import RayBundle as JaxRayBundle
from fruitnerf_tpu.engine.trainer import init_train_state as jax_init_train_state
from fruitnerf_tpu.export import volume_sampler as jvs
from fruitnerf_tpu.export.ply import read_ply
from fruitnerf_tpu.fields.encodings import GridEncodingConfig as JaxGrid
from fruitnerf_tpu.models.fruit_model import forward_export as jax_forward_export
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.core.math import normalize_aabb_to_unit
from fruitnerf_tpu_torch.core.rays import RayBundle
from fruitnerf_tpu_torch.export import volume_sampler as vs
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig
from fruitnerf_tpu_torch.models.fruit_model import forward_export

N_CAMS = 4
GRID = dict(num_levels=4, table_size=512, base_res=4, max_res=64, mid_table_size=256,
            fine_levels=2)
FWD_RTOL = 1e-5  # export outputs, of each output's max magnitude
FLIP_TOL = 1e-4  # a flip's value lies within this (relative, min 1) of its threshold
MAX_FLIPS = 1e-3  # flipped probes, as a share of all probes
POINT_ATOL = 1e-6  # surviving points, output space of +-2
COLOR_ATOL = 1e-5  # their rgb and sigmoid
N = 24  # probes a side
RAYS = 288  # rays a batch: two batches


@pytest.fixture(scope="module")
def models():
    """(JAX model config, JAX parameters, the port's model config, the port's
    parameters), with O(1) grid entries so the grid shapes the field."""
    jcfg = jconfigs.fruit_nerf(N_CAMS, compute_dtype=jnp.float32)
    jfield = dataclasses.replace(jcfg.model.field, grid=JaxGrid(mode="cell", **GRID))
    jmodel = dataclasses.replace(jcfg.model, field=jfield)
    params = jax.tree.map(np.asarray, jax_init_train_state(
        jax.random.PRNGKey(3), dataclasses.replace(jcfg, model=jmodel), N_CAMS).params)
    field = params["model"]["field"]
    field["grid_table"] = tuple(t * 1e4 for t in field["grid_table"])
    tcfg = configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32)
    tgrid = GridEncodingConfig(**GRID)
    tmodel = dataclasses.replace(
        tcfg.model, field=dataclasses.replace(tcfg.model.field, grid=tgrid))
    tparams = bridge.params_from_jax(params, tmodel, "cpu")["model"]
    jparams = jax.tree.map(jnp.asarray, params["model"])
    return jmodel, jparams, tmodel, tparams


def test_normalize_aabb_to_unit_matches_jax():
    """Interior points, points on each face (selector 0) and outside ones."""
    aabb = np.array([[-1.0, -2.0, -0.5], [1.0, 2.0, 1.5]], np.float32)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 2.0, (64, 3)).astype(np.float32)
    x[:6] = np.array([[-1, 0, 0], [1, 0, 0], [0, -2, 0], [0, 2, 0], [0, 0, -0.5], [0, 0, 1.5]])
    jpos, jsel = jax_normalize(jnp.asarray(x), jnp.asarray(aabb))
    pos, sel = normalize_aabb_to_unit(torch.from_numpy(x), torch.from_numpy(aabb))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert not sel[:6].any() and sel[6:].any() and not sel[6:].all()


def _bundles(n: int):
    origins, direction, far = vs.orthographic_ray_grid(vs.ExportConfig().aabb, n)
    r = origins.shape[0]
    jb = JaxRayBundle(
        origins=jnp.asarray(origins), directions=jnp.broadcast_to(jnp.asarray(direction), (r, 3)),
        nears=jnp.zeros((r,)), fars=jnp.full((r,), far), camera_indices=jnp.zeros((r,), jnp.int32),
    )
    tb = RayBundle(
        origins=torch.from_numpy(origins), directions=torch.from_numpy(direction).expand(r, 3),
        nears=torch.zeros(r), fars=torch.full((r,), far), camera_indices=torch.zeros(r, dtype=torch.int64),
    )
    return jb, tb


_BOX = np.array([[-1.0] * 3, [1.0] * 3], np.float32)


def _jax_export(models, n):
    jmodel, jparams, _, _ = models
    jb, _ = _bundles(n)
    out = jax_forward_export(jparams, jb, jmodel, n, jnp.asarray(_BOX))
    return {k: np.asarray(v) for k, v in out.items()}


def test_forward_export_matches_jax(models):
    """Uniform deterministic samples, AABB normalization (probes on the box's
    faces get density 0), the mean appearance embedding."""
    n = 8
    _, _, tmodel, tparams = models
    _, tb = _bundles(n)
    want = _jax_export(models, n)
    with torch.inference_mode():
        got = forward_export(tparams, tb, tmodel, n, torch.from_numpy(_BOX))
    for k in ("positions", "density", "rgb", "semantics", "semantics_prob"):
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape, k
        err = np.abs(g - w).max()
        assert err <= FWD_RTOL * np.abs(w).max(), (k, err)
    face = np.abs(want["positions"]).max(-1) >= 1.0
    assert face.any() and (got["density"].numpy()[face] == 0).all()


def _probe_index(points: np.ndarray, n: int) -> np.ndarray:
    """Output-space points (x2 of world) -> flat probe index (ray * n + sample)."""
    w = points / 2.0
    i = np.rint((w[:, 0] + 1.0) / 2.0 * (n - 1)).astype(np.int64)
    j = np.rint((w[:, 1] + 1.0) / 2.0 * (n - 1)).astype(np.int64)
    k = np.floor((w[:, 2] + 1.0) / 2.0 * n).astype(np.int64)
    return (i * n + j) * n + k


def test_sample_volume_matches_jax(models, tmp_path, monkeypatch):
    """N = 24 in two batches, thresholds at quantiles of the JAX run's own
    values; the JAX twin compacts with room for every probe. Same surviving
    probes up to flips within FLIP_TOL of a threshold, same points and
    colours, and ``.ply`` files that read back."""
    jmodel, jparams, tmodel, tparams = models
    ref = _jax_export(models, N)
    dens, logit, prob = (ref[k].reshape(-1) for k in ("density", "semantics", "semantics_prob"))
    thr = (float(np.quantile(logit, 0.3)), float(np.quantile(dens, 0.4)),
           float(np.quantile(prob, 0.5)))
    kw = dict(num_points_per_side=N, num_rays_per_batch=RAYS, semantic_logit_threshold=thr[0],
              density_threshold=thr[1], colormap_prob_threshold=thr[2])
    jout = jvs.sample_volume(jparams, jmodel, jvs.ExportConfig(compaction_fraction=1.0, **kw),
                             dataparser_scale=1.0, output_dir=tmp_path / "jax", progress=False)
    calls = []
    real = vs.forward_export

    def spy(*args):
        calls.append(args[1].num_rays)
        return real(*args)

    monkeypatch.setattr(vs, "forward_export", spy)
    tout = vs.sample_volume(tparams, tmodel, vs.ExportConfig(**kw), dataparser_scale=1.0,
                            output_dir=tmp_path / "port", progress=False)
    assert calls == [RAYS, RAYS]

    def near(values, t):
        return np.abs(values - t) <= FLIP_TOL * max(1.0, abs(t))

    near_thr = {
        "density": near(dens, thr[1]),
        "semantic": near(dens, thr[1]) | near(logit, thr[0]),
        "semantic_colormap": near(dens, thr[1]) | near(prob, thr[2]),
    }
    flips = 0
    for name in vs.CLOUDS:
        j, t = jout[name], tout[name]
        assert t["overflowed"] == 0 == j["overflowed"]
        assert 0.1 <= len(j["points"]) / N**3 <= 0.9, (name, len(j["points"]))
        ij, it = _probe_index(j["points"], N), _probe_index(t["points"], N)
        assert (np.diff(ij) > 0).all() and (np.diff(it) > 0).all()  # probe order, no repeats
        flipped = np.setxor1d(ij, it)
        assert near_thr[name][flipped].all(), (name, flipped)
        flips += len(flipped)
        common = np.intersect1d(ij, it)
        rj, rt = np.searchsorted(ij, common), np.searchsorted(it, common)
        np.testing.assert_allclose(t["points"][rt], j["points"][rj], atol=POINT_ATOL, rtol=0)
        np.testing.assert_allclose(t["colors"][rt], j["colors"][rj], atol=COLOR_ATOL, rtol=0)
        back = read_ply(t["path"])
        np.testing.assert_array_equal(back["points"], t["points"].astype(np.float32))
        assert back["colors"].shape == (len(t["points"]), 4)
    assert flips <= MAX_FLIPS * N**3


@pytest.mark.parametrize("n, rays", [(24, 32768), (256, 16384), (384, 10922), (1000, 4194),
                                     (8192, 1024)])
def test_rays_per_batch_caps_probes(n, rays):
    """The JAX twin's batch rule: at most 2^22 probes a batch, at least 1024
    rays."""
    assert vs.rays_per_batch(vs.ExportConfig(num_points_per_side=n)) == rays


def test_export_config_matches_jax():
    j, t = jvs.ExportConfig(), vs.ExportConfig()
    names = {f.name for f in dataclasses.fields(t)}
    assert names == {f.name for f in dataclasses.fields(j)} - {"compaction_fraction"}
    assert all(getattr(t, k) == getattr(j, k) for k in names)
    np.testing.assert_array_equal(t.aabb, j.aabb)
