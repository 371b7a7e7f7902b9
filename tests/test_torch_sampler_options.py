"""The three FruitModelConfig sampler options against the JAX package's
``forward_train`` on the same parameters and draws (the smoke preset,
float32): ``use_single_jitter=False`` (one uniform a bin: [R, n+1] for the
spaced sampler, [R, N+1] for each PDF stage), ``proposal_initial_sampler=
"uniform"`` (every stage spaced uniformly, the JAX package's semantics) and
``use_proposal_weight_anneal=False`` (anneal exponent 1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.core.rays import RayBundle as JaxBundle
from fruitnerf_tpu.models import fruit_model as jfm
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.core.rays import RayBundle
from fruitnerf_tpu_torch.models import fruit_model as tfm

R = 16
STEP = 50  # inside the smoke preset's 200-step anneal: the exponent is 0.84
# float32 renders of 16 rays and the proposal weights (observed <= 4.2e-7)
ATOL = 2e-6
# the bins in s-space: the uniform sampler's far bins are wide, so a
# float32 difference of the proposal weights moves the resampled fine bins
# most there (observed <= 2.0e-6; the piecewise sampler <= 3.6e-7)
SDIST_ATOL = 5e-6
OPTIONS = {
    "default": {},
    "single_jitter_off": {"use_single_jitter": False},
    "uniform_sampler": {"proposal_initial_sampler": "uniform"},
    "anneal_off": {"use_proposal_weight_anneal": False},
}


def _bundles():
    rng = np.random.default_rng(0)
    origins = rng.uniform(-0.2, 0.2, (R, 3)).astype(np.float32)
    origins[:, 2] += 2.0
    dirs = rng.normal(size=(R, 3)).astype(np.float32) * 0.2
    dirs[:, 2] = -1.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    near, far = np.full((R,), 0.05, np.float32), np.full((R,), 6.0, np.float32)
    cams = np.arange(R) % 3
    jb = JaxBundle(jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(near), jnp.asarray(far),
                   jnp.asarray(cams, jnp.int32))
    tb = RayBundle(torch.tensor(origins), torch.tensor(dirs), torch.tensor(near),
                   torch.tensor(far), torch.tensor(cams, dtype=torch.int64))
    return jb, tb


def _forward(option: str):
    jmodel = dataclasses.replace(jconfigs.fruit_nerf_smoke(3).model, **OPTIONS[option])
    tmodel = dataclasses.replace(configs.fruit_nerf_smoke(3).model, **OPTIONS[option])
    jparams = jfm.init_fruit_model(jax.random.PRNGKey(0), jmodel)
    tree = {"model": jax.tree.map(np.asarray, jparams), "camera_opt": np.zeros((3, 6), np.float32)}
    tparams = bridge.params_from_jax(tree, tmodel, "cpu")["model"]
    jb, tb = _bundles()
    key = jax.random.PRNGKey(1)
    shapes = tfm.sampler_draw_shapes(tmodel, R)
    # the JAX sampler's own draws: one key a stage, uniform of the stage's shape
    draws = [torch.tensor(np.asarray(jax.random.uniform(k, s)))
             for k, s in zip(jax.random.split(key, len(shapes)), shapes)]
    fwd = jax.jit(jfm.forward_train, static_argnames=("config", "train"))
    jout = fwd(jparams, jb, config=jmodel, key=key, step=jnp.asarray(STEP), train=True)
    with torch.no_grad():
        tout = tfm.forward_train(tparams, tb, tmodel, draws, step=STEP, train=True)
    return jout, tout, shapes


@pytest.mark.parametrize("option", list(OPTIONS))
def test_forward_train_matches_jax(option):
    jout, tout, shapes = _forward(option)
    if option == "single_jitter_off":
        assert shapes == [(R, 49), (R, 33), (R, 25)]
    for k in ("rgb", "accumulation", "depth", "semantics"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=ATOL, rtol=1e-4,
                                   err_msg=k)
    for i, (wt, wj) in enumerate(zip(tout["weights_list"], jout["weights_list"])):
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=ATOL, err_msg=f"weights {i}")
    for i, (st, sj) in enumerate(zip(tout["sdist_list"], jout["sdist_list"])):
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SDIST_ATOL,
                                   err_msg=f"sdist {i}")


@pytest.mark.parametrize("option", ["single_jitter_off", "uniform_sampler", "anneal_off"])
def test_each_option_changes_the_samples(option):
    """Each option moves the fine samples away from the default's."""
    _, base, _ = _forward("default")
    _, tout, _ = _forward(option)
    assert not np.allclose(tout["sdist_list"][-1].numpy(), base["sdist_list"][-1].numpy())


def test_anneal_is_one_when_switched_off():
    m = configs.fruit_nerf_smoke(3).model
    assert tfm.proposal_anneal(STEP, m) < 1.0
    off = dataclasses.replace(m, use_proposal_weight_anneal=False)
    assert tfm.proposal_anneal(STEP, off) == 1.0 == float(jfm.proposal_anneal(
        jnp.asarray(STEP), dataclasses.replace(jconfigs.fruit_nerf_smoke(3).model,
                                               use_proposal_weight_anneal=False)))
