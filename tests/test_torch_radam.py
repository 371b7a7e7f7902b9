"""The port's per-group optimizer against the JAX package's
``engine/trainer.py:make_optimizer`` (``optax.multi_transform`` of
``optax.radam``/``optax.adam`` groups) on a small parameter tree with the
big preset's groups: RAdam on the fields and proposal groups, Adam on the
appearance group (with its decoupled decay) and the camera group (with its
warmup, shortened here so that it ends inside the run). Twelve steps from
the same gradients cross RAdam's rectification switch at step 6 (rho_t
first reaches 5 there); then a checkpoint taken at step 7 is restored and
stepped on, and must equal the unbroken run."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fruitnerf_tpu import configs as jconfigs
from fruitnerf_tpu.engine import trainer as jtrainer
from fruitnerf_tpu_torch import bridge, configs
from fruitnerf_tpu_torch.engine import checkpoints as ck
from fruitnerf_tpu_torch.engine import trainer

STEPS = 12
RESUME_AT = 7
# Each parameter after every step, against optax, absolute, on parameters of
# O(1) and updates of 1e-6..3e-3. The RAdam groups: float32 elementwise work
# in optax's order with float32 step scalars computed in optax's order
# (observed <= 9.3e-10, most leaves bitwise). torch.optim.RAdam, whose
# scalars are float64, misses optax by up to 1e-2 of a step's update from
# step 6 on. The Adam groups step trainer.adam_step (torch's foreach Adam
# arithmetic on staged float32 scalars), which rounds otherwise than
# optax.adam (observed <= 4.8e-7, two ulps of the appearance table).
ATOL = {"radam": 1e-8, "adam": 1e-6}
GROUP_OF = {"/camera_opt": "adam", "/model/field/appearance": "adam"}


def _config():
    cfg = jconfigs.fruit_nerf_big(4)
    port = configs.fruit_nerf_big(4)
    camera = dict(warmup_steps=4)
    return (dataclasses.replace(cfg, max_iters=STEPS,
                                camera_opt=dataclasses.replace(cfg.camera_opt, **camera)),
            dataclasses.replace(port, max_iters=STEPS,
                                camera_opt=dataclasses.replace(port.camera_opt, **camera)))


def _tree(rng):
    """A parameter tree of the train state's shape, small."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"model": {"field": {"grid_table": a(40, 16), "base_mlp": {"w0": a(8, 5), "b0": a(5)},
                                "appearance": a(4, 6)},
                      "proposal_networks": [{"mlp": {"w0": a(6, 3), "b0": a(3)}},
                                            {"mlp": {"w0": a(7, 2)}}]},
            "camera_opt": a(4, 6) * 0.01}


def _port_state(tree, cfg):
    params = bridge.tree_map(tree, lambda x: torch.tensor(x))
    return trainer.TrainState(params=params, optimizer=trainer.make_optimizer(params, cfg))


def _port_step(state, grads, cfg):
    """The optimizer part of ``trainer.train_step``, on given gradients."""
    for t, g in zip(bridge.tree_leaves(state.params), bridge.tree_leaves(grads)):
        t.grad = torch.tensor(g)
    trainer.stage_scalars(state, cfg)
    trainer.optimizer_step(state, cfg)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    grads = [bridge.tree_map(tree, lambda x: (rng.standard_normal(x.shape) * 0.1)
                             .astype(np.float32)) for _ in range(STEPS)]
    jcfg, tcfg = _config()
    tx = jtrainer.make_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    jax_params = []
    for g in grads:
        up, opt_state = update(jax.tree.map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, up)
        jax_params.append(jax.tree.map(np.asarray, jparams))
    state = _port_state(tree, tcfg)
    port_params = []
    for g in grads:
        _port_step(state, g, tcfg)
        port_params.append(bridge.tree_map(state.params, lambda t: t.detach().numpy().copy()))
    return dict(tree=tree, grads=grads, tcfg=tcfg, jax=jax_params, port=port_params)


def test_groups_take_the_algorithm_their_config_names(runs):
    state = _port_state(runs["tree"], runs["tcfg"])
    assert trainer.group_algorithms(state.optimizer) == {
        "fields": "radam", "proposal_networks": "radam", "appearance": "adam",
        "camera_opt": "adam"}
    assert isinstance(state.optimizer, trainer.GroupOptimizer)


@pytest.mark.parametrize("step", range(STEPS))
def test_each_step_matches_optax(runs, step):
    """Every parameter after ``step + 1`` optimizer steps, across the
    rectification switch (steps 1-5 take the momentum update, 6 on the
    rectified one) and the camera group's warmup (lr 0 before step 4)."""
    for (path, pj, pt) in _leaves(runs["jax"][step], runs["port"][step]):
        atol = ATOL[GROUP_OF.get(path, "radam")]
        np.testing.assert_allclose(pt, pj, rtol=0, atol=atol, err_msg=f"{path} step {step}")


def _leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _leaves(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaves(x, y, f"{path}/{i}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def test_rectifier_matches_optax_scale_by_radam():
    """On a constant gradient of 1 the bias-corrected moments are 1, so
    ``optax.scale_by_radam``'s update at step t is its rectifier r_t (from
    step 6, where rho_t reaches 5) or 1 (the momentum update before): the
    port's float32 scalars give the same to 2e-5 (observed <= 7.1e-6: the
    moments' rounding and the last bit of b2^t). The float64 rectifier that
    torch.optim.RAdam computes is 5.7e-3 off at step 6."""
    tx = optax.scale_by_radam(eps=0.0)
    g = jnp.ones((1,), jnp.float32)
    opt = tx.init(g)
    update = jax.jit(tx.update)
    for t in range(1, 40):
        u, opt = update(g, opt)
        _, _, r = trainer.RAdam.scalars(t)
        assert (r is None) == (t < 6), t
        np.testing.assert_allclose(1.0 if r is None else r, float(u[0]), rtol=2e-5,
                                   err_msg=f"step {t}")
        if t == 6:
            ro_inf = 2.0 / (1.0 - 0.999) - 1.0
            ro = ro_inf - 2 * t * 0.999**t / (1 - 0.999**t)
            r64 = math.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
            assert abs(r64 / float(u[0]) - 1.0) > 1e-3


def test_resume_from_a_checkpoint_continues_the_unbroken_run(runs, tmp_path):
    """A checkpoint written at step RESUME_AT (after the switch), restored
    into a fresh state and stepped on with the same gradients, lands on the
    unbroken run's parameters bitwise."""
    tcfg, grads = runs["tcfg"], runs["grads"]
    state = _port_state(runs["tree"], tcfg)
    for g in grads[:RESUME_AT]:
        _port_step(state, g, tcfg)
    path = ck.save_checkpoint(tmp_path, state)
    fresh = ck.load_checkpoint(path, _port_state(runs["tree"], tcfg))
    assert fresh.step == RESUME_AT
    for g in grads[RESUME_AT:]:
        _port_step(fresh, g, tcfg)
    for (p, want, got) in _leaves(runs["port"][-1],
                                  bridge.tree_map(fresh.params, lambda t: t.detach().numpy())):
        np.testing.assert_array_equal(got, want, err_msg=p)


def test_an_all_adam_preset_keeps_torch_adam():
    """The presets whose groups are all Adam step one torch.optim.Adam, as
    before RAdam was ported, so their checkpoints keep their format."""
    rng = np.random.default_rng(1)
    state = _port_state(_tree(rng), configs.fruit_nerf(4))
    assert type(state.optimizer) is torch.optim.Adam
    assert set(trainer.group_algorithms(state.optimizer).values()) == {"adam"}
