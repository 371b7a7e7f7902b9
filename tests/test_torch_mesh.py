"""Data-parallel training (fruitnerf_tpu_torch/parallel/mesh.py): two gloo
ranks spawned on the CPU, each in a fresh interpreter where JAX cannot be
imported, against one rank, through ``train_loop(mesh=)`` on the
``fruit_nerf_smoke`` and grid presets (the JAX package's 1-vs-N check,
``__graft_entry__.py:119-133`` and tests/test_train_e2e.py:183); the
two-rank step against JAX's ``make_train_step(config, mesh=make_mesh())``
on the 8 virtual CPU devices, on the same parameters and draws; and the
checks the mesh makes (a batch that does not divide, parameters that
differ between ranks)."""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_orchard_e2e import BLOCK, REPO
from test_torch_train_step import (
    FLIP_REL_G, FLIP_SHARE, GRID, LOSS_RTOL, N_CAMS, OVERRIDES, PARAM_ATOL, _jax_draws,
    _jax_grads, _leaves, _shrink,
)
from test_torch_train_step import setup  # noqa: F401  (the grid step's fixture)

from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu.parallel.mesh import make_mesh
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig
from fruitnerf_tpu_torch.parallel import mesh as M

# __graft_entry__.py:130's bound between the N-device and the 1-device loss
DP_LOSS_RTOL = 2e-5
# Parameters after two steps, two ranks against one: the averaged gradient
# differs from the one-rank gradient in float32 rounding, and Adam steps by
# lr * g / (|g| + eps), so an entry whose gradient is near zero may move by
# up to its full lr either way. Entries more than PARAM_ATOL apart: at most
# FLIP_SHARE of a leaf (or one entry of a small leaf), each at most two full
# steps apart. Observed: losses within 2.2e-7 relative, every parameter
# of both presets within 9.9e-8.
MAX_LR = 1e-2  # the largest lr_init of any group of both presets
STEPS = 2

# One rank: loads the job, joins the gloo group through a file, trains
# (train_loop from the job's seed, or train_step on the job's draws) and
# saves its metrics and parameters.
RANK = BLOCK + """
import json, sys, torch
torch.set_num_threads(1)
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.parallel import mesh as M
from fruitnerf_tpu_torch.utils.writer import MetricWriter
job_path, rank, world, init, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
job = torch.load(job_path, weights_only=False)
mesh = M.init_data_mesh("gloo", world, rank, init)
try:
    cfg, data = job["config"], job["data"]
    params = job["params"][rank] if isinstance(job["params"], list) else job["params"]
    state = trainer.init_train_state(cfg, data.cameras.num_cameras, "cpu", params=params)
    metrics = []
    if job["draws"] is None:
        run = job["run_dirs"][rank]
        writer = MetricWriter(run + "/metrics.jsonl")
        gen = torch.Generator().manual_seed(cfg.seed)
        trainer.train_loop(cfg, data, state=state, generator=gen, writer=writer,
                           checkpoint_dir=run + "/checkpoints", mesh=mesh,
                           callbacks=[lambda it, st, m: metrics.append(
                               {k: float(v) for k, v in m.items()})])
        writer.close()
    else:
        M.check_replicated(state.params, mesh)
        for d in job["draws"]:
            m = trainer.train_step(state, data, cfg, draws=d, mesh=mesh)
            metrics.append({k: float(v) for k, v in m.items()})
    torch.save({"metrics": metrics, "params": state.params,
                "grads": trainer.tree_map(state.params, lambda t: t.grad)}, out)
finally:
    M.close_data_mesh()
"""


def run_ranks(job: dict, world: int, tmp_path, check=True) -> list:
    """Run ``world`` ranks of RANK on ``job`` at once; -> each rank's saved
    result (or, with check=False, the finished processes)."""
    job_path = tmp_path / "job.pt"
    torch.save(job, job_path)
    init = f"file://{tmp_path / 'pg_init'}"
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(job_path), str(r), str(world), init,
         str(tmp_path / f"rank{r}.pt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for r in range(world)]
    outs = [p.communicate(timeout=240) for p in procs]
    if not check:
        return [(p.returncode, o) for p, o in zip(procs, outs)]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, so[-2000:] + se[-4000:]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _config(name):
    """The smoke preset with 64 rays, or the grid preset as
    tests/test_torch_train_step.py shrinks it (64 rays, 64 sparsity points):
    both divide over 2 ranks (and JAX's 8 devices)."""
    if name == "smoke":
        cfg = configs.apply_overrides(configs.fruit_nerf_smoke(N_CAMS),
                                      {"train_rays_per_batch": 64})
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_nerf_samples=8, num_proposal_samples=(16, 8)))
    else:
        cfg = _shrink(configs.apply_overrides(
            configs.fruit_nerf(N_CAMS, compute_dtype=torch.float32), OVERRIDES),
            GridEncodingConfig(**GRID), torch.float32, chunk=100)
    return dataclasses.replace(cfg, max_iters=STEPS, steps_per_save=1, steps_per_eval=0,
                               steps_per_log=1)


@pytest.fixture(scope="module")
def data():
    scene = render_scene(SyntheticSceneConfig(num_fruits=4, image_size=24, num_cameras=N_CAMS,
                                              num_leaves=6), device="cpu")
    return dataset_from_scene(scene, "cpu")


def _close_after_adam(a: torch.Tensor, b: torch.Tensor, path: str):
    d = (a - b).abs()
    apart = int((d > PARAM_ATOL).sum())
    assert apart <= max(1, FLIP_SHARE * d.numel()), (path, apart)
    assert float(d.max()) <= 2 * STEPS * MAX_LR, path


@pytest.mark.parametrize("name", ["smoke", "grid"])
def test_two_gloo_ranks_match_one(name, data, tmp_path):
    """``train_loop`` on two ranks from one seed against one rank: losses
    within DP_LOSS_RTOL each step, the parameters after two steps close
    (Adam, above), the ranks bitwise equal; only rank 0 writes
    ``metrics.jsonl`` and checkpoints."""
    cfg = _config(name)
    params = trainer.init_train_state(cfg, N_CAMS, "cpu",
                                      generator=torch.Generator().manual_seed(cfg.seed)).params
    params = bridge.tree_map(params, lambda t: t.detach().clone())
    torch.set_num_threads(1)
    one = trainer.init_train_state(cfg, N_CAMS, "cpu",
                                   params=bridge.tree_map(params, lambda t: t.clone()))
    ref = []
    trainer.train_loop(cfg, data, state=one, generator=torch.Generator().manual_seed(cfg.seed),
                       callbacks=[lambda it, st, m: ref.append({k: float(v)
                                                                for k, v in m.items()})])
    dirs = [str(tmp_path / f"run{r}") for r in range(2)]
    ranks = run_ranks({"config": cfg, "data": data, "params": params, "draws": None,
                       "run_dirs": dirs}, 2, tmp_path)
    assert len(ranks[0]["metrics"]) == len(ref) == STEPS
    for step, (m, r) in enumerate(zip(ranks[0]["metrics"], ref)):
        for k in ("total_loss", "rgb_loss", "semantics_loss", "interlevel_loss", "psnr"):
            np.testing.assert_allclose(m[k], r[k], rtol=DP_LOSS_RTOL, err_msg=f"{step} {k}")
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for a, b in zip(bridge.tree_leaves(ranks[0]["params"]), bridge.tree_leaves(ranks[1]["params"])):
        assert torch.equal(a, b)
    for (path, a, b) in _leaves(bridge.tree_map(ranks[0]["params"], lambda t: t.detach()),
                                bridge.tree_map(one.params, lambda t: t.detach())):
        _close_after_adam(torch.as_tensor(a), b, path)
    lines = (tmp_path / "run0" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    assert sorted(p.name for p in (tmp_path / "run0" / "checkpoints").iterdir())
    assert (tmp_path / "run1" / "metrics.jsonl").read_text() == ""  # opened, not written
    assert not (tmp_path / "run1" / "checkpoints").exists()


def test_two_ranks_match_the_jax_mesh_step(setup, tmp_path):  # noqa: F811
    """JAX's data-parallel step over its 8 virtual CPU devices against the
    port's two gloo ranks, on the grid step of tests/test_torch_train_step.py
    (bridged parameters, the JAX step's draws): the losses at that file's
    LOSS_RTOL; the parameters after Adam at its tolerances, and the two
    ranks bitwise equal."""
    assert len(jax.devices()) == 8
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    key = jax.random.PRNGKey(1)
    jstate = jax.tree.map(jnp.array, setup["jstate"])
    jnew, jm = jtrainer.make_train_step(jcfg, mesh=make_mesh())(jstate, setup["jdata"], key)
    params = bridge.params_from_jax(setup["params0"], tcfg.model, "cpu")
    ranks = run_ranks({"config": tcfg, "data": setup["tdata"], "params": params,
                       "draws": [_jax_draws(key, 0, jcfg, setup["jdata"])]}, 2, tmp_path)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    (tm,) = ranks[0]["metrics"]
    for k in ("rgb_loss", "semantics_loss", "interlevel_loss", "sparsity_loss", "total_loss",
              "psnr", "distortion"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    model = tcfg.model
    gj_tree = _jax_grads(jnew.opt_state, model)
    pj = bridge.tree_map(bridge.params_from_jax(jax.tree.map(np.asarray, jnew.params), model,
                                                "cpu"), lambda t: t.numpy())
    tparams = bridge.tree_map(ranks[0]["params"], lambda t: t.detach().numpy())
    tgrads = bridge.tree_map(ranks[0]["grads"], lambda t: t.numpy())
    flips_total = 0
    for (path, gj, gt), (_, p_j, p_t) in zip(_leaves(gj_tree, tgrads), _leaves(pj, tparams)):
        same = np.sign(gj) == np.sign(gt)
        np.testing.assert_allclose(p_t[same], p_j[same], atol=PARAM_ATOL, rtol=0, err_msg=path)
        flips = ~same
        flips_total += int(flips.sum())
        assert flips.sum() <= FLIP_SHARE * flips.size, path
        assert np.all(np.abs(gj[flips]) <= FLIP_REL_G * np.abs(gj).max()), path
    assert flips_total <= 10
    for a, b in zip(bridge.tree_leaves(ranks[0]["params"]), bridge.tree_leaves(ranks[1]["params"])):
        assert torch.equal(a, b)


def test_a_batch_that_does_not_divide_raises(data):
    """Rays and sparsity points must divide over the ranks, as the JAX
    test sizes its batch ``32 * n_devices``; checked before any step."""
    mesh = M.DataMesh(rank=0, world_size=3)
    cfg = _config("grid")
    with pytest.raises(ValueError, match="train_rays_per_batch = 64 is not divisible"):
        M.check_batch(cfg, mesh)
    draws = trainer.draw_step(cfg, data, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible by the data-parallel world size 3"):
        M.shard_draws(draws, mesh)
    rays_ok = dataclasses.replace(cfg, train_rays_per_batch=66)
    with pytest.raises(ValueError, match="sparsity_num_points = 64"):
        M.check_batch(rays_ok, mesh)
    with pytest.raises(ValueError, match="backend must be"):
        M.init_data_mesh("mpi", 1, 0)


def test_ranks_with_other_parameters_refuse_to_train(data, tmp_path):
    """Every rank must start from rank 0's parameters: where one rank's
    differ, every rank raises (none is left waiting for a peer)."""
    cfg = _config("smoke")
    params = [bridge.tree_map(trainer.init_train_state(
        cfg, N_CAMS, "cpu", generator=torch.Generator().manual_seed(seed)).params,
        lambda t: t.detach().clone()) for seed in (0, 1)]
    done = run_ranks({"config": cfg, "data": data, "params": params, "draws": []}, 2, tmp_path,
                     check=False)
    for rank, (code, (_, err)) in enumerate(done):
        assert code != 0, rank
        assert "the ranks' initial parameters differ" in err, err[-2000:]
    assert "this rank's differ from rank 0's" in done[1][1][1]
