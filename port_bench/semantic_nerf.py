"""What the ``semantic_nerf_loop`` entry (``entries/semantic_nerf_loop.py``)
and its controls (``control_semantic_nerf.py``) add to the shared training
harness for a configuration whose main field is the reference's
``SemanticNeRFField`` (``reference/semantic_nerf.py``): the initial
parameters from the seed, the reference's checked steps, the two sides of
the comparison that ``check.numbers`` decides on, and the counted least
work of the traced window.

The parameters are made as ``weights.py`` makes FruitField's (He-uniform
MLP weights over each layer's whole input, a skip layer's the joined one,
zero biases, camera-opt zero; one uniform draw on the device over every
leaf), in the tree the port's train state takes: ``{"model": {"field":
{"base_mlp", "density_head", "color_mlp", "semantic_mlp"},
"proposal_networks": [...]}, "camera_opt": [N, 6]}``.

The least work is ``counts.py``'s arithmetic (``counts.mlp_pass`` a layer,
the optimizer at the memory rate) on this field's layers: every product's
forward; its weight gradient; its input gradient where the step needs one
(every layer past the first of the trunk and the heads, the colour head's
first; the trunk's first layer and its skip layer's encoded part where
camera-opt moves the samples; none into the detached semantic branch).
The skip layer and the colour head's first layer are counted at their
joined inputs, 319 and 283 wide at the published widths, the products the
published field makes. The proposal fields are counted as
``counts.step_least`` counts them.
"""
from __future__ import annotations

import torch

from . import check, counts, weights as W
from .reference import model as RM, semantic_nerf as SN
from .reference.optim import Optimizer, leaves


def leaf_specs(cfg: dict, num_images: int) -> list[tuple[tuple, tuple, str, float]]:
    """[(tree path, shape, kind, scale)] of every parameter (``weights.leaf_specs``'
    form: kind "he" is uniform +-scale, "zero" zero)."""
    out = []

    def add(prefix, layers):
        for i, (a, b) in enumerate(layers):
            out.append(((*prefix, f"w{i}"), (a, b), "he", (6.0 / a) ** 0.5))
            out.append(((*prefix, f"b{i}"), (b,), "zero", 0.0))

    for name, layers in SN.mlp_layers(cfg["model"]["field"]).items():
        add(("model", "field", name), layers)
    for j, net in enumerate(cfg["model"]["proposal_nets"]):
        if net["kind"] != "freq":
            raise ValueError("the semantic_nerf entry takes frequency-MLP proposal fields")
        d_in, nl, hid, d_out, _ = RM.proposal_mlp_dims(net)
        add(("model", "proposal_networks", j, "mlp"),
            list(zip([d_in] + [hid] * (nl - 1), [hid] * (nl - 1) + [d_out])))
    out.append((("camera_opt",), (num_images, 6), "zero", 0.0))
    return out


def make(cfg: dict, num_images: int, seed: int, device) -> dict:
    """The parameter tree from ``seed``."""
    specs = leaf_specs(cfg, num_images)
    numel = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni = torch.rand((sum(n for n, s in zip(numel, specs) if s[2] == "he"),), generator=gen,
                     device=device)
    tree: dict = {}
    at = 0
    for n, (path, shape, kind, scale) in zip(numel, specs):
        if kind == "he":
            t = (uni[at : at + n] * (2.0 * scale) - scale).reshape(shape)
            at += n
        else:
            t = torch.zeros(shape, device=device)
        W._put(tree, path, t)
    return tree


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def reference_steps(cfg: dict, traffic: dict, scene: dict, params: dict, draw_seed: int,
                    steps: int, dev, lower: bool = False, keep_half: bool = False,
                    frozen: bool = False) -> dict:
    """``check.reference_steps`` with this field: each step's loss, each
    leaf's first-gradient norm and each leaf's change norm after the steps;
    ``lower``, ``keep_half`` and ``frozen`` are its planted faults."""
    data = check.ref_data(scene, cfg, traffic, dev)
    hw = tuple(scene["images"].shape[1:3])
    gen = torch.Generator(device=dev).manual_seed(draw_seed)
    p0 = {path: t.detach().clone() for path, t in leaves(params)}
    for _, t in leaves(params):
        t.requires_grad_(True)
    opt = Optimizer(cfg)
    step = traffic["start_step"]
    out = {"losses": [], "grad_norms": {}}
    for i in range(steps):
        draws = RM.draw_step(cfg, len(data["train_indices"]), hw, gen, dev)
        keep = None
        if keep_half:
            keep = torch.arange(cfg["train_rays_per_batch"], device=dev) % 2 == 0
        total, _ = SN.loss(params, data, cfg, draws, step, lower, keep)
        lv = leaves(params)
        grads = torch.autograd.grad(total, [t for _, t in lv], allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(lv, grads)]
        out["losses"].append(float(total.detach().double()))
        if i == 0:
            out["grad_norms"] = {path: float(torch.linalg.vector_norm(g.double()))
                                 for (path, _), g in zip(lv, grads)}
        if not frozen:
            opt.step(lv, grads, step)
        step += 1
        del total, grads
    out["change_norms"] = {path: float(torch.linalg.vector_norm((t.detach() - p0[path]).double()))
                           for path, t in leaves(params)}
    return out


def program_side(res, cfg: dict, dev) -> list[dict]:
    """The program's numbers (one scene), its change worked out against the
    initial parameters made again from the seed."""
    c = res.checked
    p0 = make(cfg, res.info["num_images"], res.inputs["seeds"]["weights"], dev)
    change = {path: float(torch.linalg.vector_norm((c.after[path].to(dev) - t).double()))
              for path, t in leaves(p0)}
    return [{"losses": [step[0] for step in c.loss_values()],
             "grad_norms": {path: v[0] for path, v in c.grad_norms.items()},
             "change_norms": change}]


def reference_side(res, cfg: dict, traffic: dict, dev, **fault) -> list[dict]:
    """The reference's numbers (one scene) from the same seeds."""
    (scene,) = res.inputs["scenes"]
    seeds = res.inputs["seeds"]
    p = make(cfg, res.info["num_images"], seeds["weights"], dev)
    out = [reference_steps(cfg, traffic, scene, p, seeds["draws"], res.checked.steps, dev,
                           **fault)]
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the least work
# ---------------------------------------------------------------------------


def _layer(n: int, a: int, b: int, dtype: str, backward: bool, dx: bool = False) -> float:
    """Least seconds of one layer a -> b over ``n`` rows: its forward, or
    its weight gradient and, with ``dx``, its input gradient."""
    return counts.mlp_pass(n, (a, 1, b, b, False), dtype, backward, dx)


def step_least(cfg: dict, num_images: int, step: int) -> dict:
    """{piece: least seconds} of one train step at ``step``: the MLP
    products by stage ("mlp.field", "mlp.sparsity", "mlp.proposals"), their
    sum "mlp", "optimizer" and "total"."""
    m, field = cfg["model"], cfg["model"]["field"]
    r = cfg["train_rays_per_batch"]
    n = r * m["num_nerf_samples"]
    dt = field["compute_dtype"]
    dpos = bool(cfg["use_camera_opt"])  # the samples move with the camera poses
    layers = SN.mlp_layers(field)
    pos = 3 + 6 * field["pos_frequencies"]

    def trunk(rows: int, moves: bool) -> float:
        s = 0.0
        for i, (a, b) in enumerate(layers["base_mlp"]):
            s += _layer(rows, a, b, dt, False) + _layer(rows, a, b, dt, True)
            if i == 0:
                s += _layer(rows, a, b, dt, False) if moves else 0.0  # dX of the encoding
            elif i in field["skip_layers"] and not moves:
                s += _layer(rows, a - pos, b, dt, False)  # dX of the hidden part alone
            else:
                s += _layer(rows, a, b, dt, False)
        return s

    def head(rows: int, name: str, first_dx: bool) -> float:
        s = 0.0
        for i, (a, b) in enumerate(layers[name]):
            s += _layer(rows, a, b, dt, False) + _layer(rows, a, b, dt, True, i > 0 or first_dx)
        return s

    out = {"mlp.field": trunk(n, dpos) + head(n, "density_head", True)
           + head(n, "color_mlp", True) + head(n, "semantic_mlp", False)}
    out["mlp.sparsity"] = 0.0
    if m["density_sparsity_mult"] > 0:
        sp = m["sparsity_num_points"]
        out["mlp.sparsity"] = trunk(sp, False) + head(sp, "density_head", True)
    updated = RM.proposal_updated(step, m)
    out["mlp.proposals"] = 0.0
    for i, net in enumerate(m["proposal_nets"]):
        rows = r * m["num_proposal_samples"][i]
        pd = RM.proposal_mlp_dims(net)
        out["mlp.proposals"] += counts.mlp_pass(rows, pd, net["compute_dtype"], False, False)
        if updated:
            out["mlp.proposals"] += counts.mlp_pass(rows, pd, net["compute_dtype"], True, False)
    out["mlp"] = out["mlp.field"] + out["mlp.sparsity"] + out["mlp.proposals"]
    n_p = sum(int(torch.Size(shape).numel()) for _, shape, _, _ in leaf_specs(cfg, num_images))
    out["optimizer"] = counts.least(counts.ADAM_BYTES * n_p, counts.ADAM_OPS * n_p,
                                    counts.PEAK_FP32_FLOPS)
    out["total"] = out["mlp"] + out["optimizer"]
    return out


def window_least(cfg: dict, num_images: int, steps) -> dict:
    """{piece: least seconds} summed over the window's ``steps``."""
    acc: dict = {}
    for step in steps:
        for k, v in step_least(cfg, num_images, step).items():
            acc[k] = acc.get(k, 0.0) + v
    return acc
