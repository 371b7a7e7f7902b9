"""The train step as CUDA graphs (``engine/step_graph.py``) and the device
scalars it reads (``engine/trainer.py:StepScalars``).

On the CPU, which runs the card's one step path eagerly: the staged
scalars equal ``learning_rate``, ``RAdam.scalars`` and ``proposal_anneal``
bitwise across the camera group's warm-up, RAdam's threshold and the
anneal's end; RAdam's update on staged scalars equals its frozen update on
the host's floats, and both equal the update it had before one formula
covered both sides of the threshold; the replay rule; the graph cache
captures once a key and again when an input is replaced; the same rule and
cache for the multi-scene step, which equals the frozen staged multi-scene
step bitwise; the eager step against the step on torch's Adam as it was,
over 12 steps, to a measured bound; ``train_step`` equals the frozen staged
step bitwise; an eager step's calls of the loss and the optimizer; the
``graph`` spans and their reader.

On a card (marked ``gpu``, skipped without one): 12 steps from a resumed
state, graphed against eager on the same draws, on the grid preset (Adam)
and the huge parity preset (corner hash, RAdam from its first count), and
on the base parity preset (the published network: corner hash, hash
proposal fields, Adam) with its K3/K4 launches counted, and on the big tpu
preset (frequency-encoded main field, frequency proposals, RAdam) with no
grid launch and the frequency-encoding pair's launches counted, are
bitwise equal in every loss, parameter, moment, step count, the
generator's state and the next draws, with equal kernel launch counts; the
staged Adam step is torch's Adam step bitwise; a checkpoint taken mid-run
resumes to the same next 5 steps; 12 campaign-shaped steps of 4 scenes
through ``multi_scene_step`` (from the campaign's start, and from an
annealing one) are bitwise equal graphed and eager. This file
imports no JAX, so it runs on the card:

    python -m pytest --noconftest -q tests/test_torch_step_graph.py
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch.func import grad_and_value, vmap

from fruitnerf_tpu_torch.bridge import stack_trees, tree_leaves
from fruitnerf_tpu_torch.configs import OptimizerConfig, fruit_nerf_smoke, get_preset
from fruitnerf_tpu_torch.data.builder import dataset_from_scene
from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
from fruitnerf_tpu_torch.engine import step_graph, trainer
from fruitnerf_tpu_torch.engine.step_graph import replay_key
from fruitnerf_tpu_torch.engine.trainer import (
    RAdam, StepScalars, draw_step, graph_reads, init_train_state, learning_rate,
    make_optimizer, stage_scalars, train_step,
)
from fruitnerf_tpu_torch.models.fruit_model import proposal_anneal
from fruitnerf_tpu_torch.ops import hash_grid as hg
from fruitnerf_tpu_torch.parallel import multi_scene as ms
from fruitnerf_tpu_torch.utils import profiling
from fruitnerf_tpu_torch.utils.profiling import Span
from port_bench import harness
from port_bench.metrics_context import Context
from port_bench.trace import DeviceEvent, grid_part

STEPS = 12
# the smoke preset's anneal and proposal warm-up end at step 200; from 195
# the proposals train every 5th step
START = 195


def _radam(cfg):
    radam = OptimizerConfig(name="radam")
    return dataclasses.replace(cfg, fields_opt=radam, proposal_opt=radam)


@pytest.fixture(scope="module")
def data():
    scene = render_scene(SyntheticSceneConfig(num_fruits=3, fruit_radius=0.13, num_cameras=6,
                                              image_size=24, num_leaves=4), device="cpu")
    return dataset_from_scene(scene, "cpu")


@pytest.fixture(scope="module")
def config(data):
    cfg = fruit_nerf_smoke(data.cameras.num_cameras)
    model = dataclasses.replace(cfg.model, density_sparsity_mult=0.005, sparsity_num_points=64)
    return dataclasses.replace(cfg, model=model, train_rays_per_batch=64)


def _tiny_params(rng):
    def a(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32), requires_grad=True)

    return {"model": {"field": {"grid_table": a(40, 16), "mlp": {"w0": a(8, 5)},
                                "appearance": a(4, 6)},
                      "proposal_networks": [{"mlp": {"w0": a(6, 3)}}]},
            "camera_opt": a(4, 6)}


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_staged_scalars_equal_the_host_values_bitwise():
    """The huge preset's groups (RAdam on the fields and proposals, Adam on
    the appearance, with its decay, and the camera, whose rate is 0 until
    step 2500): each slot is the float32 of what the host's step computes
    (``RAdam.scalars``; torch's foreach Adam's bias corrections and step
    size), over steps that cross the camera's warm-up, the anneal's end
    (step 1000) and RAdam's threshold (count 6)."""
    cfg = get_preset("fruit_nerf_huge", 4, variant="parity")
    opt = make_optimizer(_tiny_params(np.random.default_rng(0)), cfg)
    scalars = StepScalars(opt, "cpu")
    radam, adam = opt.parts["radam"], opt.parts["adam"]
    opts = trainer._group_configs(cfg)
    steps = [*range(0, 4), *range(995, 1005), *range(2495, 2505), 10_000]
    for count, step in enumerate(steps):
        for o in (radam, adam):
            for group in o.param_groups:
                o.state[group["params"][0]] = {"step": count if o is radam else torch.tensor(
                    float(count))}
        got = scalars.values(step, cfg)
        want = [proposal_anneal(step, cfg.model)]
        for group in radam.param_groups:
            lr = learning_rate(opts[group["name"]], step, cfg.max_iters)
            bc1, bc2, r = RAdam.scalars(count + 1)
            want += [-lr, group["weight_decay"] * lr, bc1,
                     *((np.inf, 1.0, 1.0) if r is None else (bc2, r, group["eps"]))]
        for group in adam.param_groups:
            lr = learning_rate(opts[group["name"]], step, cfg.max_iters)
            t = float(count + 1)
            want += [1 - lr * group["weight_decay"], (1 - 0.999 ** t) ** 0.5,
                     (lr / (1 - 0.9 ** t)) * -1]
        assert got.dtype == np.float32 and np.array_equal(got, np.float32(want)), (step, count)
    assert np.float32(learning_rate(cfg.camera_opt, 2499, cfg.max_iters)) == 0.0
    assert cfg.appearance_opt.weight_decay > 0 and adam.param_groups[0]["betas"] == (0.9, 0.999)
    assert RAdam.scalars(5)[2] is None and RAdam.scalars(6)[2] is not None


class _SeedRAdam(RAdam):
    """``RAdam.step`` as it was before one formula covered both sides of the
    threshold (frozen)."""

    @torch.no_grad()
    def step(self, scalars=None):
        assert scalars is None
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = self.B1, self.B2
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=0, exp_avg=torch.zeros_like(p),
                                         exp_avg_sq=torch.zeros_like(p))
            states = [self.state[p] for p in params]
            count = states[0]["step"] + 1
            bc1, bc2, r = self.scalars(count)
            grads = [p.grad for p in params]
            mu = [st["exp_avg"] for st in states]
            nu = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            upd = torch._foreach_div(mu, bc1)
            if r is not None:
                den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
                torch._foreach_add_(den, group["eps"])
                upd = torch._foreach_div(torch._foreach_mul(upd, r), den)
            lr = group["lr"]
            torch._foreach_mul_(upd, -lr)
            if group["weight_decay"]:
                torch._foreach_sub_(upd, torch._foreach_mul(params, group["weight_decay"] * lr))
            torch._foreach_add_(params, upd)
            for st in states:
                st["step"] = count


class _HostRAdam(RAdam):
    """``RAdam.step`` on the host's floats, as it was beside the step on
    staged scalars (frozen): each group's ``step_scalars`` from its count
    and rate, counted here."""

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = self.B1, self.B2
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=0, exp_avg=torch.zeros_like(p),
                                         exp_avg_sq=torch.zeros_like(p))
            states = [self.state[p] for p in params]
            count = states[0]["step"] + 1
            neg_lr, wd_lr, bc1, bc2, r, floor = self.step_scalars(
                count, group["lr"], group["weight_decay"], group["eps"])
            grads = [p.grad for p in params]
            mu = [st["exp_avg"] for st in states]
            nu = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, floor)
            upd = torch._foreach_div(torch._foreach_mul(upd, r), den)
            torch._foreach_mul_(upd, neg_lr)
            if group["weight_decay"]:
                torch._foreach_sub_(upd, torch._foreach_mul(params, wd_lr))
            torch._foreach_add_(params, upd)
            for st in states:
                st["step"] = count


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3], ids=["no_decay", "decay"])
def test_radam_on_staged_scalars_equals_the_host_floats_and_the_seed(weight_decay):
    """Counts 1-10 from the same gradients: the update on staged float32
    scalars, the frozen update on the host's floats, and the frozen update
    of before one formula covered both sides of the threshold are bitwise
    equal; below the threshold the denominator is exactly 1."""
    rng = np.random.default_rng(1)
    init = [rng.standard_normal(s).astype(np.float32) for s in ((30, 4), (7,))]
    runs = []
    for kind in ("staged", "host", "seed"):
        ps = [torch.tensor(a) for a in init]
        cls = {"staged": RAdam, "host": _HostRAdam, "seed": _SeedRAdam}[kind]
        opt = cls([{"params": ps, "lr": 1e-2, "eps": 1e-8, "weight_decay": weight_decay}])
        for count in range(1, 11):
            g = np.random.default_rng(100 + count)
            for p in ps:
                p.grad = torch.tensor(g.standard_normal(tuple(p.shape)).astype(np.float32))
            if kind == "staged":
                s = RAdam.step_scalars(count, 1e-2, weight_decay, 1e-8)
                opt.step([torch.tensor(np.float32(s))])
                opt.advance()
            else:
                opt.step()
        runs.append([p.clone() for p in ps] + [opt.state[p][k] for p in ps
                                               for k in ("exp_avg", "exp_avg_sq")])
        assert all(opt.state[p]["step"] == 10 for p in ps)
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def _eager_reasons(monkeypatch, module, steps) -> list[bool]:
    """The ``eager`` that each of ``steps`` (callables) hands ``run_step``."""
    seen = []
    with monkeypatch.context() as m:
        m.setattr(module, "run_step", lambda *args, eager: seen.append(eager) or {})
        for step in steps:
            step()
    return seen


def test_the_engagement_rule(config, data, monkeypatch):
    """No graphs (the CPU, or a state's first step on a card), ``eager`` or
    an optimizer without state: no key. With graphs and state, the key is
    the proposal gate and whether the anneal runs: four keys over steps
    that cross both. RAdam below its threshold replays too (its rectifier
    is a staged scalar). ``train_step`` runs eagerly with given draws or a
    mesh. On the CPU the step stages its scalars there and captures
    nothing."""
    cfg = _radam(config)
    state = init_train_state(cfg, data.cameras.num_cameras, "cpu",
                             generator=torch.Generator().manual_seed(0))
    state.step = START
    gen = torch.Generator().manual_seed(1)
    stage_scalars(state, cfg)
    state.graphs = step_graph.StepGraphs()
    assert replay_key(state, cfg) is None  # no optimizer state yet
    state.graphs = None
    train_step(state, data, cfg, gen)
    assert state.graphs is None and state.scalars.buffer.device.type == "cpu"
    assert replay_key(state, cfg) is None  # no graphs
    state.graphs = step_graph.StepGraphs()  # as a card's first step leaves them
    assert replay_key(state, cfg, eager=True) is None
    radam = state.optimizer.parts["radam"]
    assert trainer.step_count(radam, radam.param_groups[0]) == 1
    keys = {replay_key(dataclasses.replace(state, step=s), cfg) for s in range(START, START + 7)}
    # (the proposals train, the anneal runs): from 195 every 5th step trains, the anneal ends at 200
    assert keys == {(True, True), (False, True), (True, False), (False, False)}
    assert _eager_reasons(monkeypatch, step_graph, [
        lambda: train_step(state, data, cfg, gen),
        lambda: train_step(state, data, cfg, draws=draw_step(cfg, data, gen)),
        lambda: train_step(state, data, cfg, gen, mesh=object())]) == [False, True, True]


class _FakeCapture:
    """A ``CapturedStep`` without a card: runs the step at capture and each
    replay, and counts captures."""

    made = 0

    def __init__(self, step, generators, pool=None):
        type(self).made += 1
        self.step = step
        self.generators = list(generators)
        self.graph = SimpleNamespace(pool=lambda: "pool")

    def replay(self):
        return self.step()


def test_the_cache_captures_a_gate_once_and_again_after_a_replacement(config, data, monkeypatch):
    """Two gate values, two captures; replaying them captures nothing;
    replacing a parameter, the optimizer's state or the data drops every
    graph and captures again."""
    monkeypatch.setattr(step_graph, "CapturedStep", _FakeCapture)
    _FakeCapture.made = 0
    state = init_train_state(config, data.cameras.num_cameras, "cpu",
                             generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    train_step(state, data, config, gen)
    graphs = step_graph.StepGraphs()

    def run(key, d=data):
        return graphs.run(key, graph_reads(state, d, config, [gen]), [gen], lambda: {"k": key})

    for key in (True, False, True, False):
        assert run(key) == {"k": key}
    assert _FakeCapture.made == 2 and set(graphs.graphs) == {True, False}
    leaf = state.params["camera_opt"]
    state.params["camera_opt"] = leaf.detach().clone().requires_grad_(True)
    run(True)
    assert _FakeCapture.made == 3 and set(graphs.graphs) == {True}
    state.optimizer.load_state_dict(state.optimizer.state_dict())  # the same tensors
    run(True)
    assert _FakeCapture.made == 3
    sd = state.optimizer.state_dict()
    sd = {**sd, "state": {k: {n: t.clone() for n, t in v.items()} for k, v in sd["state"].items()}}
    state.optimizer.load_state_dict(sd)
    run(True)
    assert _FakeCapture.made == 4
    run(True, dataclasses.replace(data, images=data.images.clone()))
    assert _FakeCapture.made == 5


def _multi(config, data, scenes=2):
    """A multi-scene state of ``scenes`` copies of the scene, its stacked
    data and its scene generators."""
    datas = ms.stack_datasets([data] * scenes)
    state, gens = ms.init_multi_scene_state(config, data.cameras.num_cameras, scenes, "cpu")
    return state, datas, gens


def test_the_multi_scene_engagement_rule(config, data, monkeypatch):
    """``train_step``'s rule (no graphs, which the CPU never makes, or no
    optimizer state: no key; else the proposal gate and whether the anneal
    runs, four keys over steps that cross both), and the multi-scene step
    eager with given draws or scene groups on two or more devices, not with
    one group. On the CPU the step stages its scalars there and captures
    nothing."""
    state, datas, gens = _multi(config, data)
    state.step = START
    stage_scalars(state, config)
    state.graphs = step_graph.StepGraphs()
    assert replay_key(state, config) is None  # no optimizer state yet
    state.graphs = None
    ms.multi_scene_step(state, datas, config, gens)
    ms.multi_scene_step(state, datas, config, gens, devices=["cpu", "cpu"])
    assert state.graphs is None and state.scalars.buffer.device.type == "cpu"
    state.graphs = step_graph.StepGraphs()
    keys = {replay_key(dataclasses.replace(state, step=s), config) for s in range(START, START + 7)}
    assert keys == {(True, True), (False, True), (True, False), (False, False)}
    draws = [draw_step(config, ms.scene_dataset(datas, s), g) for s, g in enumerate(gens)]
    assert _eager_reasons(monkeypatch, ms, [
        lambda: ms.multi_scene_step(state, datas, config, gens),
        lambda: ms.multi_scene_step(state, datas, config, gens, devices=["cpu"]),
        lambda: ms.multi_scene_step(state, datas, config, draws=draws),
        lambda: ms.multi_scene_step(state, datas, config, gens, devices=["cpu", "cpu"]),
    ]) == [False, False, True, True]


def _replace(what, state, datas, gens):
    """Put another object in place of one that a multi-scene step reads ->
    the stacked data."""
    if what == "generator":
        gens[1] = torch.Generator().manual_seed(5)
    elif what == "parameter":
        state.params["camera_opt"] = state.params["camera_opt"].clone()
    elif what == "moment":
        opt = next(o for o in trainer._parts(state.optimizer) if o.state)
        st = next(iter(opt.state.values()))
        st["exp_avg"] = st["exp_avg"].clone()
    elif what == "data":
        datas = dataclasses.replace(datas, masks=datas.masks.clone())
    else:
        cams = datas.cameras
        datas = dataclasses.replace(datas, cameras=dataclasses.replace(
            cams, camera_to_worlds=cams.camera_to_worlds.clone()))
    return datas


@pytest.mark.parametrize("what", ["generator", "data", "cameras", "parameter", "moment"])
def test_the_multi_scene_cache_captures_again_after_a_replacement(config, data, monkeypatch,
                                                                  what):
    """A multi-scene step's reads (``trainer.graph_reads`` over every scene
    generator and the stacked data): two gate values, two captures, each
    registering every scene's generator in order; replays capture nothing;
    replacing one scene's generator, the stacked data, its cameras, a
    parameter or a moment drops every graph and captures again."""
    monkeypatch.setattr(step_graph, "CapturedStep", _FakeCapture)
    _FakeCapture.made = 0
    state, datas, gens = _multi(config, data)
    ms.multi_scene_step(state, datas, config, gens)
    graphs = step_graph.StepGraphs()

    def run(key, d):
        return graphs.run(key, graph_reads(state, d, config, gens), gens, lambda: {"k": key})

    for key in (True, False, True, False):
        assert run(key, datas) == {"k": key}
    assert _FakeCapture.made == 2 and set(graphs.graphs) == {True, False}
    assert all(g.generators == gens and len(gens) == 2 for g in graphs.graphs.values())
    datas = _replace(what, state, datas, gens)
    run(True, datas)
    assert _FakeCapture.made == 3 and set(graphs.graphs) == {True}
    run(True, datas)
    assert _FakeCapture.made == 3


def _both(cfg):
    """RAdam on the fields and proposals, Adam on the appearance and the
    camera, whose warm-up is gone, so that every group moves."""
    return dataclasses.replace(
        _radam(cfg), camera_opt=dataclasses.replace(cfg.camera_opt, warmup_steps=0))


def _frozen_stage(state, config):
    """The step's scalars copied in by hand (frozen)."""
    if state.scalars is None:
        state.scalars = StepScalars(state.optimizer, "cpu")
    values = state.scalars.values(state.step, config)
    state.scalars.buffer.copy_(torch.from_numpy(values))
    state.scalars.annealing = bool(values[0] != 1.0)


def _frozen_optimizer_step(state):
    """The optimizer step on staged scalars, as the card's eager step took
    it (frozen)."""
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    for opt in trainer._parts(state.optimizer):
        if isinstance(opt, RAdam):
            opt.step(state.scalars.radam)
        else:
            trainer.adam_step(opt, state.scalars.adam)
    trainer.count_step(state)


def _frozen_multi_step(state, datas, config, gens):
    """The card's eager multi-scene step on staged scalars (frozen): the
    scenes' draws, one vmapped loss and gradient whose scenes share the
    staged anneal, the optimizer -> the [S] losses."""
    _frozen_stage(state, config)
    draws = [draw_step(config, ms.scene_dataset(datas, s), g) for s, g in enumerate(gens)]
    draw_fields = stack_trees([{f.name: getattr(d, f.name) for f in dataclasses.fields(d)}
                               for d in draws])

    def loss(params, fields, d):
        scene = trainer.TrainState(params=params, optimizer=None, step=state.step,
                                   scalars=state.scalars)
        total, losses, metrics = trainer.compute_loss(scene, ms._dataset(fields), config,
                                                      trainer.StepDraws(**d))
        return total, (losses, metrics)

    grads, (total, _) = vmap(grad_and_value(loss, has_aux=True))(
        state.params, ms._fields(datas), draw_fields)
    for p, g in zip(tree_leaves(state.params), tree_leaves(grads)):
        p.grad = g
    _frozen_optimizer_step(state)
    return total.detach()


def test_the_multi_scene_step_on_staged_scalars_equals_the_step_on_host_floats(
        config, data, one_thread):
    """``multi_scene_step`` on the CPU against the card's eager multi-scene
    step on staged scalars (frozen; the anneal a device scalar closed over
    by the vmapped loss, shared by the scenes): 12 steps of 2 scenes from
    195 (the anneal's end, both gate values, RAdam's threshold), RAdam and
    Adam groups: bitwise equal [S] losses, parameters and step counts."""
    cfg = _both(config)
    runs = []
    for frozen in (False, True):
        state, datas, gens = _multi(cfg, data)
        state.step = START
        losses = [(_frozen_multi_step(state, datas, cfg, gens) if frozen
                   else ms.multi_scene_step(state, datas, cfg, gens)["total_loss"])
                  for _ in range(STEPS)]
        counts = [trainer.step_count(opt, g) for opt in trainer._parts(state.optimizer)
                  for g in opt.param_groups]
        runs.append((torch.stack(losses), [t.detach().clone() for t in tree_leaves(state.params)],
                     state.step, counts))
    (la, pa, sa, ca), (lb, pb, sb, cb) = runs
    assert la.shape == (STEPS, 2)
    assert set(trainer.group_algorithms(state.optimizer).values()) == {"adam", "radam"}
    assert torch.equal(la, lb) and (sa, ca) == (sb, cb) == (START + STEPS, ca)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def _seed_step(state, data, config, generator):
    """The eager train step as it was before its scalars could live on the
    device (frozen): torch's Adam and the frozen RAdam on the host's floats
    at the groups' rates. Its loss reads the staged anneal, which equals
    the host's."""
    _frozen_stage(state, config)
    draws = draw_step(config, data, generator)
    total, losses, metrics = trainer.compute_loss(state, data, config, draws)
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    opts = trainer._group_configs(config)
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate(opts[group["name"]], state.step, config.max_iters)
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    for opt in trainer._parts(state.optimizer):
        opt.step()
    state.step += 1
    return total.detach()


def _frozen_step(state, data, config, generator):
    """The card's eager train step on staged scalars (frozen)."""
    _frozen_stage(state, config)
    draws = draw_step(config, data, generator)
    total, _, _ = trainer.compute_loss(state, data, config, draws)
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    _frozen_optimizer_step(state)
    return total.detach()


@pytest.fixture
def one_thread():
    """A CPU run repeats bitwise on one thread only."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# train_step against the step on torch's Adam, 12 steps on the smoke preset,
# absolute: the Adam groups take the card's arithmetic (adam_step), which
# rounds otherwise than torch's single-tensor CPU Adam by about one ulp a
# step. Observed: losses 5.96e-8 (one ulp of a loss of 0.5-1), MLP weights
# of O(1) 5.96e-8, hash-table entries of 1e-2 2.56e-6 (Adam's normalised
# step on gradients near eps moves them by a share of the rate). The RAdam
# case (Adam on the appearance and the camera only) came out bitwise.
SEED_STEP_ATOL = {"loss": 1.2e-7, "param": 5e-6}


@pytest.mark.parametrize("algo", ["adam", "radam"])
def test_the_eager_step_on_the_cpu_is_the_seed_step(config, data, algo, one_thread):
    """Twelve steps from step 195 (the anneal's end and both gate values;
    with RAdam its threshold too), ``train_step`` against the frozen step on
    torch's Adam on the same draws: every loss and parameter within
    ``SEED_STEP_ATOL``."""
    cfg = _radam(config) if algo == "radam" else config
    runs = []
    for frozen in (False, True):
        gen = torch.Generator().manual_seed(3)
        state = init_train_state(cfg, data.cameras.num_cameras, "cpu",
                                 generator=torch.Generator().manual_seed(0))
        state.step = START
        if frozen and algo == "radam":
            state.optimizer.parts["radam"].__class__ = _SeedRAdam
        losses = [(_seed_step(state, data, cfg, gen) if frozen
                   else train_step(state, data, cfg, gen)["total_loss"]) for _ in range(STEPS)]
        runs.append((torch.stack(losses), [t.detach().clone() for t in tree_leaves(state.params)]))
    (la, pa), (lb, pb) = runs
    torch.testing.assert_close(la, lb, rtol=0, atol=SEED_STEP_ATOL["loss"])
    for a, b in zip(pa, pb):
        torch.testing.assert_close(a, b, rtol=0, atol=SEED_STEP_ATOL["param"])


def test_the_step_on_staged_scalars_equals_the_step_on_host_floats(config, data, one_thread):
    """``train_step`` on the CPU against the card's eager step on staged
    scalars (frozen), 12 steps from 195 with RAdam and Adam groups:
    bitwise equal, and the step counts agree."""
    cfg = _both(config)
    runs = []
    for frozen in (False, True):
        gen = torch.Generator().manual_seed(3)
        state = init_train_state(cfg, data.cameras.num_cameras, "cpu",
                                 generator=torch.Generator().manual_seed(0))
        state.step = START
        losses = [(_frozen_step(state, data, cfg, gen) if frozen
                   else train_step(state, data, cfg, gen)["total_loss"]) for _ in range(STEPS)]
        counts = [trainer.step_count(opt, g) for opt in trainer._parts(state.optimizer)
                  for g in opt.param_groups]
        runs.append((torch.stack(losses), [t.detach().clone() for t in tree_leaves(state.params)],
                     state.step, counts))
    (la, pa, sa, ca), (lb, pb, sb, cb) = runs
    assert set(trainer.group_algorithms(state.optimizer).values()) == {"adam", "radam"}
    assert torch.equal(la, lb) and (sa, ca) == (sb, cb) == (START + STEPS, ca)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


@pytest.mark.parametrize("step", ["train_step", "multi_scene_step"])
def test_an_eager_step_calls_the_loss_and_the_optimizer_as_agreed(config, data, monkeypatch,
                                                                  step):
    """Two eager steps on the CPU call exactly ``compute_loss(state, data,
    config, draws)`` (a multi-scene step once a scene, each scene's state
    carrying the step's staged scalars) and ``optimizer_step(state,
    config)`` (on scalars staged for the step), through the names in
    ``trainer`` and in ``multi_scene``, which the benchmark's fault tests
    patch."""
    cfg = _both(config)
    module = trainer if step == "train_step" else ms
    calls = []
    loss, opt_step = module.compute_loss, module.optimizer_step

    def spy_loss(*args, **kwargs):
        calls.append(("loss", args, kwargs))
        return loss(*args, **kwargs)

    def spy_step(*args, **kwargs):
        calls.append(("optimizer", args, kwargs))
        state, config = args
        assert np.array_equal(state.scalars.buffer.numpy(),
                              state.scalars.values(state.step, config))
        return opt_step(*args, **kwargs)

    monkeypatch.setattr(module, "compute_loss", spy_loss)
    monkeypatch.setattr(module, "optimizer_step", spy_step)
    if step == "train_step":
        state = init_train_state(cfg, data.cameras.num_cameras, "cpu",
                                 generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        datas = data
        steps = [lambda: train_step(state, data, cfg, gen)] * 2
    else:
        state, datas, gens = _multi(cfg, data)
        steps = [lambda: ms.multi_scene_step(state, datas, cfg, gens)] * 2
    state.step = START
    for i, run in enumerate(steps):
        run()
        kinds = [c[0] for c in calls]
        assert kinds == ["loss", "optimizer"] * (i + 1), kinds
    for kind, args, kwargs in calls:
        assert kwargs == {}
        if kind == "optimizer":
            assert len(args) == 2 and args[0] is state and args[1] is cfg
            continue
        scene, d, c, draws = args
        assert c is cfg and isinstance(draws, trainer.StepDraws)
        assert scene.scalars is state.scalars
        assert (scene is state and d is datas) if step == "train_step" else (
            scene.optimizer is None and tuple(d.images.shape) == tuple(data.images.shape))
    assert state.step == START + 2


def _span(name, a, b):
    return Span(name, None, 7, a * 1_000_000, b * 1_000_000, 0)


@pytest.mark.parametrize("names, want", [((), None), (("graph", "graph", "log"), 1.0),
                                         (("draws", "backward", "optimizer"), 0.0)],
                         ids=["no_spans", "replays", "eager"])
def test_the_replay_reader(monkeypatch, names, want):
    """``step.graph_replays_per_step``: ``graph`` spans over the steps; None
    where nothing was recorded."""
    read = harness.load_reader("step.graph_replays_per_step")
    spans = [_span(n, i, i + 1) for i, n in enumerate(names)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    ctx = Context(trace=SimpleNamespace(window_s=0.1), work={}, steps=2,
                  host_cpu_s_per_step=0.02, wall_s_per_step=0.025)
    assert read(ctx) == want


@pytest.mark.parametrize("name", ["graph", "graph.capture"])
def test_the_graph_spans_are_read_by_no_older_rule(name):
    """Kernels whose outermost op is a graph span read as no grid, optimizer
    or MLP work by their op chain, and no host reader takes the span."""
    mine = harness._load(harness.HERE, "metrics", "optimizer.device_ms")._mine
    matmuls = harness._load(harness.HERE, "metrics", "model.mlp_device_ms").MATMULS
    for ops in ((name,), ("cudaGraphLaunch", name)):
        e = DeviceEvent("void elementwise_kernel", 0.0, 1.0, ops)
        assert grid_part(e) is None and not mine(e) and e.ops[0] not in matmuls
    forward = harness._load(harness.HERE, "metrics", "model.forward_host_ms")
    assert name not in forward.STAGES and not name.startswith(forward.PREFIXES)
    assert name not in harness._load(harness.HERE, "metrics", "step.backward_host_ms").STAGES


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    dev = torch.device("cuda", 0)
    scene = render_scene(SyntheticSceneConfig(image_size=64, num_cameras=8), device=dev)
    return dev, dataset_from_scene(scene, dev)


def _card_config(name, n):
    if name == "grid":
        from fruitnerf_tpu_torch.configs import apply_overrides

        return apply_overrides(get_preset("fruit_nerf", n), {"sparsity_loss": 0.005})
    return get_preset("fruit_nerf_huge", n, variant="parity")


def _moments(optimizer) -> list[torch.Tensor]:
    return [t for opt in trainer._parts(optimizer) for st in opt.state.values()
            for t in st.values() if isinstance(t, torch.Tensor)]


def _card_run(cfg, data, start, graphed, steps=STEPS):
    dev, n = data.images.device, data.cameras.num_cameras
    state = init_train_state(cfg, n, dev, generator=torch.Generator(device=dev).manual_seed(0))
    state.step = start
    gen = torch.Generator(device=dev).manual_seed(1)
    hg.reset_launch_counts()
    losses, gens = [], []
    for _ in range(steps):
        if graphed:
            m = train_step(state, data, cfg, gen)
        else:
            m = train_step(state, data, cfg, draws=draw_step(cfg, data, gen))
        losses.append(m["total_loss"])
        gens.append(gen.get_state())
    torch.cuda.synchronize(dev)
    return {"losses": torch.stack(losses).cpu(), "gens": gens,
            "params": [t.detach().clone() for t in tree_leaves(state.params)],
            "moments": [t.clone() for t in _moments(state.optimizer)],
            "counts": [trainer.step_count(opt, g) for opt in trainer._parts(state.optimizer)
                       for g in opt.param_groups],
            "launches": (dict(hg.LAUNCHES), dict(hg.SCENES)),
            "next": draw_step(cfg, data, gen),
            "keys": sorted(state.graphs.graphs) if state.graphs else []}


@pytest.mark.gpu
@pytest.mark.parametrize("name, start", [("grid", 10_000), ("huge", 10_000), ("grid", 20)],
                         ids=["grid", "huge_parity", "grid_annealing"])
def test_graphed_steps_equal_eager_steps(card, name, start):
    """Twelve steps from ``start`` with a fresh optimizer (its first step
    eager, then replays; RAdam from count 1, across its threshold), against
    the same steps eager on the same draws: bitwise equal."""
    dev, data = card
    cfg = _card_config(name, data.cameras.num_cameras)
    g = _card_run(cfg, data, start, graphed=True)
    e = _card_run(cfg, data, start, graphed=False)
    assert g["keys"] == ([(False, False), (True, False)] if start == 10_000 else [(True, True)])
    assert e["keys"] == []
    assert torch.equal(g["losses"], e["losses"])
    assert all(torch.equal(a, b) for a, b in zip(g["params"], e["params"]))
    assert len(g["moments"]) == len(e["moments"])
    assert all(torch.equal(a, b) for a, b in zip(g["moments"], e["moments"]))
    assert g["counts"] == e["counts"]
    assert all(torch.equal(a, b) for a, b in zip(g["gens"], e["gens"]))
    assert all(torch.equal(a, b) for a, b in zip(
        [*g["next"].sampler, g["next"].slot, g["next"].jitter, g["next"].sparse_points],
        [*e["next"].sampler, e["next"].slot, e["next"].jitter, e["next"].sparse_points]))
    assert g["launches"] == e["launches"] and sum(g["launches"][0].values()) > 0


def _graphed_and_eager_from_10000(cfg, data):
    """Twelve steps from 10,000 graphed and eager on the same draws, held
    bitwise equal in losses, step counts, parameters, moments, generators
    and the next draws, with both gate keys captured -> (graphed, eager)."""
    g = _card_run(cfg, data, 10_000, graphed=True)
    e = _card_run(cfg, data, 10_000, graphed=False)
    assert g["keys"] == [(False, False), (True, False)] and e["keys"] == []
    assert torch.equal(g["losses"], e["losses"]) and g["counts"] == e["counts"]
    for k in ("params", "moments", "gens"):
        assert len(g[k]) == len(e[k]) and all(torch.equal(a, b) for a, b in zip(g[k], e[k])), k
    assert all(torch.equal(a, b) for a, b in zip(
        [*g["next"].sampler, g["next"].slot, g["next"].jitter, g["next"].sparse_points],
        [*e["next"].sampler, e["next"].slot, e["next"].jitter, e["next"].sparse_points]))
    return g, e


@pytest.mark.gpu
def test_graphed_steps_equal_eager_steps_on_the_base_parity_network(card):
    """The published base network (``fruit_nerf`` parity with the sparsity
    prior: a 16 x 2^19 corner hash grid, two hash proposal fields, Adam),
    twelve steps from 10,000, graphed against eager on the same draws:
    bitwise equal, with K3 launched 4 times a step (the fine samples, the
    sparsity points, two proposal fields) and K4 twice, and twice more on
    the steps that train the proposals."""
    from fruitnerf_tpu_torch.configs import apply_overrides
    from fruitnerf_tpu_torch.models.fruit_model import proposal_updated

    dev, data = card
    cfg = apply_overrides(get_preset("fruit_nerf", data.cameras.num_cameras, variant="parity"),
                          {"sparsity_loss": 0.005})
    g, e = _graphed_and_eager_from_10000(cfg, data)
    gated = sum(proposal_updated(s, cfg.model) for s in range(10_000, 10_000 + STEPS))
    want = {"cell_encode_fwd": 0, "cell_encode_bwd": 0, "corner_encode_fwd": 4 * STEPS,
            "corner_encode_bwd": 2 * STEPS + 2 * gated, "freq_encode_fwd": 0,
            "freq_encode_bwd": 0}
    assert gated == 3 and g["launches"] == e["launches"] == (want, want)


@pytest.mark.gpu
def test_graphed_steps_equal_eager_steps_on_the_big_frequency_network(card):
    """The big network with the table-free main field (``fruit_nerf_big``
    tpu with the sparsity prior: a 14-octave frequency encoding into
    128-wide MLPs, frequency-MLP proposals (512, 256), RAdam on every MLP),
    twelve steps from 10,000, graphed against eager on the same draws:
    bitwise equal, with no grid kernel launched and the frequency-encoding
    pair launched four times a step forward (the fine samples, the sparsity
    points, two proposal fields) and once backward (the fine samples),
    twice more on the steps that train the proposals."""
    from fruitnerf_tpu_torch.configs import apply_overrides
    from fruitnerf_tpu_torch.models.fruit_model import proposal_updated

    _, data = card
    cfg = apply_overrides(get_preset("fruit_nerf_big", data.cameras.num_cameras, variant="tpu"),
                          {"sparsity_loss": 0.005})
    assert cfg.model.field.encoding == "freq"
    g, e = _graphed_and_eager_from_10000(cfg, data)
    gated = sum(proposal_updated(s, cfg.model) for s in range(10_000, 10_000 + STEPS))
    want = {**dict.fromkeys(("cell_encode_fwd", "cell_encode_bwd", "corner_encode_fwd",
                             "corner_encode_bwd"), 0),
            "freq_encode_fwd": 4 * STEPS, "freq_encode_bwd": STEPS + 2 * gated}
    assert g["launches"] == e["launches"] == (want, want)


CAMPAIGN_SCENES = 4


@pytest.fixture(scope="module")
def card_scenes(card):
    """Four small structurally identical scenes on the card, stacked as the
    campaign stacks its orchards (every camera trained)."""
    dev, _ = card
    scenes = [render_scene(SyntheticSceneConfig(image_size=64, num_cameras=8, num_fruits=4 + s,
                                                seed=101 * s), device=dev)
              for s in range(CAMPAIGN_SCENES)]
    return ms.stack_datasets([dataset_from_scene(sc, dev, train_fraction=1.0) for sc in scenes])


def _scene_draws(cfg, datas, gens) -> list:
    return [draw_step(cfg, ms.scene_dataset(datas, s), g) for s, g in enumerate(gens)]


def _card_multi_run(cfg, datas, start, graphed, steps=STEPS):
    dev = datas.images.device
    n = datas.cameras.camera_to_worlds.shape[1]
    state, gens = ms.init_multi_scene_state(cfg, n, datas.images.shape[0], dev)
    state.step = start
    hg.reset_launch_counts()
    losses, states = [], []
    for _ in range(steps):
        if graphed:
            m = ms.multi_scene_step(state, datas, cfg, gens)
        else:
            m = ms.multi_scene_step(state, datas, cfg, draws=_scene_draws(cfg, datas, gens))
        losses.append(m["total_loss"])
        states.extend(g.get_state() for g in gens)
    torch.cuda.synchronize(dev)
    nxt = _scene_draws(cfg, datas, gens)
    return {"losses": torch.stack(losses).cpu(), "gens": states,
            "params": [t.detach().clone() for t in tree_leaves(state.params)],
            "moments": [t.clone() for t in _moments(state.optimizer)],
            "counts": [trainer.step_count(opt, g) for opt in trainer._parts(state.optimizer)
                       for g in opt.param_groups],
            "launches": (dict(hg.LAUNCHES), dict(hg.SCENES)),
            "next": [t for d in nxt for t in (*d.sampler, d.slot, d.py, d.px, d.jitter,
                                              d.sparse_points)],
            "keys": sorted(state.graphs.graphs) if state.graphs else []}


@pytest.mark.gpu
@pytest.mark.parametrize("start", [2000, 20], ids=["campaign", "campaign_annealing"])
def test_graphed_multi_scene_steps_equal_eager_steps(card_scenes, start):
    """Twelve campaign-shaped steps (4 scenes of 2048 rays on the grid
    preset) from ``start``, from a fresh optimizer (its first step eager,
    then replays), through ``multi_scene_step`` with the scene generators,
    against the same steps eager on the same draws: the [S] losses, the
    parameters, the moments, the step counts, every scene generator's state
    after each step, the next draws and the grid launch counts bitwise
    equal. From 2000 the proposals train every 2nd step (both gate keys);
    from 20 the anneal runs (a device scalar that the vmapped loss closes
    over)."""
    datas = card_scenes
    cfg = dataclasses.replace(_card_config("grid", datas.cameras.camera_to_worlds.shape[1]),
                              train_rays_per_batch=2048)
    g = _card_multi_run(cfg, datas, start, graphed=True)
    e = _card_multi_run(cfg, datas, start, graphed=False)
    assert g["keys"] == ([(False, False), (True, False)] if start == 2000 else [(True, True)])
    assert e["keys"] == []
    assert g["losses"].shape == (STEPS, CAMPAIGN_SCENES) and torch.equal(g["losses"], e["losses"])
    assert g["counts"] == e["counts"]
    for k in ("params", "moments", "gens", "next"):
        assert len(g[k]) == len(e[k]) and all(torch.equal(a, b) for a, b in zip(g[k], e[k])), k
    assert g["launches"] == e["launches"] and sum(g["launches"][0].values()) > 0
    # one launch a call for every scene
    assert all(g["launches"][1][k] == CAMPAIGN_SCENES * n for k, n in g["launches"][0].items())


@pytest.mark.gpu
def test_the_staged_adam_step_is_torchs(card):
    """Five steps of ``adam_step`` on staged scalars against
    ``torch.optim.Adam.step`` (foreach on the card) from the same
    gradients, one group with decoupled decay: parameters and moments
    bitwise equal."""
    dev, _ = card
    rng = np.random.default_rng(2)
    init = [rng.standard_normal(s).astype(np.float32) for s in ((300, 7), (33,), (5, 5))]
    runs = []
    for staged in (False, True):
        ps = [torch.tensor(a, device=dev) for a in init]
        opt = torch.optim.Adam([
            {"params": ps[:2], "lr": 3e-3, "eps": 1e-15, "weight_decay": 0.0},
            {"params": ps[2:], "lr": 2e-2, "eps": 1e-8, "weight_decay": 1e-3,
             "decoupled_weight_decay": True}])
        for count in range(1, 6):
            g = np.random.default_rng(50 + count)
            for p in ps:
                p.grad = torch.tensor(g.standard_normal(tuple(p.shape)).astype(np.float32),
                                      device=dev)
            if staged:
                s = [torch.tensor(np.float32(trainer.adam_scalars(
                    count, grp["lr"], grp["weight_decay"], grp["betas"])), device=dev)
                    for grp in opt.param_groups]
                trainer.adam_step(opt, s)
                for st in opt.state.values():
                    st["step"] += 1
            else:
                opt.step()
        runs.append([p.clone() for p in ps] + _moments(opt))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_a_checkpoint_mid_run_resumes_to_the_same_steps(card, tmp_path):
    """Six graphed steps, a checkpoint, five more; a state restored from the
    checkpoint (other initial weights before it) takes the same five."""
    from fruitnerf_tpu_torch.engine.checkpoints import load_checkpoint, save_checkpoint

    dev, data = card
    cfg = _card_config("grid", data.cameras.num_cameras)
    n = data.cameras.num_cameras
    state = init_train_state(cfg, n, dev, generator=torch.Generator(device=dev).manual_seed(0))
    state.step = 10_000
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(6):
        train_step(state, data, cfg, gen)
    path = save_checkpoint(tmp_path, state, gen)
    want = torch.stack([train_step(state, data, cfg, gen)["total_loss"] for _ in range(5)])
    other = init_train_state(cfg, n, dev, generator=torch.Generator(device=dev).manual_seed(9))
    gen2 = torch.Generator(device=dev).manual_seed(5)
    load_checkpoint(path, other, gen2)
    got = torch.stack([train_step(other, data, cfg, gen2)["total_loss"] for _ in range(5)])
    assert other.graphs is not None and other.graphs.graphs
    assert torch.equal(want, got)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params),
                                                 tree_leaves(other.params)))
    assert torch.equal(gen.get_state(), gen2.get_state())
