"""The plain reference of one train step of ``FruitModel`` around the
reference's ``SemanticNeRFField`` (meyerls/FruitNeRF ``fruit_field.py:
310-410``) at the widths a configuration file's ``config`` states, in plain
PyTorch.

The field as published, each product on its joined input: the position
(contracted to [-1, 1]^3, as FruitField maps it) encoded with its octave
sines and cosines, a ReLU trunk whose skip layers take ``cat([encoding,
hidden])`` (nerfstudio's ``MLP``), a density head with ``trunc_exp`` and
the bias, a colour head on ``cat([trunk, direction encoding])`` broadcast
to every sample, and a semantic branch on the detached trunk. Around it the
step of ``model.py`` (its rays, sampler, proposal fields, renderer, losses
and draws, imported); ``optim.py`` updates it. It imports nothing of the
port and nothing of JAX.

``lower`` selects the control: every MLP matmul on operands rounded to
float8 e4m3 (``model._fp8``), the step below the configuration's bfloat16.
"""
from __future__ import annotations

import torch

from . import model as RM


def mlp_layers(field: dict) -> dict:
    """{mlp name: [(d_in, d_out)] of each layer} of the field, a skip
    layer's d_in the joined one."""
    pos, dirs = 3 + 6 * field["pos_frequencies"], 3 + 6 * field["dir_frequencies"]
    w, nl, skips = field["hidden_dim"], field["num_layers_base"], field["skip_layers"]
    hs, c = field["hidden_dim_semantic"], field["num_semantic_classes"]
    trunk = [((pos if i == 0 else w) + (pos if i in skips else 0), w) for i in range(nl)]
    sem = [(w if i == 0 else hs, c if i == field["num_layers_semantic"] - 1 else hs)
           for i in range(field["num_layers_semantic"])]
    return {"base_mlp": trunk, "density_head": [(w, 1)],
            "color_mlp": [(w + dirs, w // 2), (w // 2, 3)], "semantic_mlp": sem}


def _linear(params, i, h, dtype, lower):
    w, b = params[f"w{i}"].to(dtype), params[f"b{i}"].to(dtype)
    if lower:
        h, w = RM._fp8(h), RM._fp8(w)
    return h @ w + b


def trunk(params, x, field, dtype, lower):
    """The ReLU trunk on the encoding [..., P] -> [..., W] in ``dtype``."""
    shape = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1]).to(dtype)
    h = x
    for i in range(field["num_layers_base"]):
        inp = torch.cat([x, h], dim=-1) if i in field["skip_layers"] else h
        h = torch.relu(_linear(params, i, inp, dtype, lower))
    return h.reshape(*shape, h.shape[-1])


def _contract(positions):
    pos01, selector = RM.contract_to_unit(positions)
    return pos01 * 2.0 - 1.0, selector


def get_density(params, positions, field, lower):
    x, selector = _contract(positions)
    h = trunk(params["base_mlp"], RM.nerf_encode(x, field["pos_frequencies"]), field,
              RM.dtype_of(field["compute_dtype"]), lower)
    return _density(params, h, field, selector, lower)


def _density(params, h, field, selector, lower):
    raw = RM.mlp(params["density_head"], h, 1, False, RM.dtype_of(field["compute_dtype"]), lower)
    return RM.TruncExp.apply(raw[..., 0] + field["density_bias"]) * selector


def field_forward(params, positions, directions, field, lower):
    """-> density [R, S], rgb [R, S, 3], semantic logits [R, S, C]."""
    dt = RM.dtype_of(field["compute_dtype"])
    x, selector = _contract(positions)
    h = trunk(params["base_mlp"], RM.nerf_encode(x, field["pos_frequencies"]), field, dt, lower)
    density = _density(params, h, field, selector, lower)
    r, s = positions.shape[0], positions.shape[1]
    d = RM.nerf_encode(directions, field["dir_frequencies"])[:, None, :].expand(r, s, -1)
    rgb = RM.mlp(params["color_mlp"], torch.cat([h.float(), d], dim=-1), 2, True, dt, lower)
    sem = RM.mlp(params["semantic_mlp"], h.detach(), field["num_layers_semantic"], False, dt,
                 lower)
    return density, rgb, sem


def loss(params, data: dict, cfg: dict, draws: dict, step: int, lower=False, keep=None):
    """-> (total loss, {loss name: value}) of one step, as ``model.loss``
    computes it with this field in FruitField's place. ``keep`` (a bool
    [R] mask, or None) trains on those rays alone: a planted fault."""
    m, field = cfg["model"], cfg["model"]["field"]
    cams = data["cameras"]
    cam = data["train_indices"][draws["slot"]]
    py, px = draws["py"], draws["px"]
    rgb_gt = data["images"][cam, py, px].float() / 255.0
    mask_gt = data["masks"][cam, py, px].float()
    if cfg["train_subpixel_jitter"]:
        ray_y, ray_x = py.float() + draws["jitter"][0], px.float() + draws["jitter"][1]
    else:
        ray_y, ray_x = py, px
    adj = RM.exp_map_so3xr3(params["camera_opt"]) if cfg["use_camera_opt"] else None
    origins, dirs = RM.generate_rays(cams, cam, ray_y, ray_x, adj)
    uniforms = draws["sampler"]
    if keep is not None:
        origins, dirs, rgb_gt, mask_gt = (t[keep] for t in (origins, dirs, rgb_gt, mask_gt))
        uniforms = [u[keep] for u in uniforms]
    r = origins.shape[0]
    nears = torch.full((r,), m["near_plane"], device=origins.device)
    fars = torch.full((r,), m["far_plane"], device=origins.device)
    updated = RM.proposal_updated(step, m)
    anneal = RM.proposal_anneal(step, m)
    spacing = m["proposal_initial_sampler"]

    n0 = m["num_proposal_samples"][0]
    edges = torch.linspace(0.0, 1.0, n0 + 1, device=origins.device).expand(r, n0 + 1)
    centers = (edges[:, 1:] + edges[:, :-1]) / 2.0
    upper = torch.cat([centers, edges[:, -1:]], dim=-1)
    lower_e = torch.cat([edges[:, :1], centers], dim=-1)
    samples = RM.Samples(origins, dirs, nears, fars, lower_e + (upper - lower_e) * uniforms[0],
                         spacing)
    weights_list, sdist_list = [], []
    nets = m["proposal_nets"]
    for i, net in enumerate(nets):
        d = RM.proposal_forward(params["model"]["proposal_networks"][i], samples.positions(), net,
                                lower, None, f"proposal{i}")
        if not updated:
            d = d.detach()
        w = samples.weights(d)
        annealed = torch.pow(torch.clamp_min(w, 1e-12), anneal)
        weights_list.append(w)
        sdist_list.append(samples.s_bins)
        n_next = m["num_proposal_samples"][i + 1] if i + 1 < len(nets) else m["num_nerf_samples"]
        new_bins = RM.pdf_bins(samples.s_bins, annealed, n_next, uniforms[i + 1])
        samples = RM.Samples(origins, dirs, nears, fars, new_bins, spacing)
    density, rgb, sem = field_forward(params["model"]["field"], samples.positions(), dirs, field,
                                      lower)
    w = samples.weights(density)
    weights_list.append(w)
    sdist_list.append(samples.s_bins)
    acc_rgb = torch.sum(w[..., None] * rgb, dim=-2)
    acc = torch.sum(w, dim=-1, keepdim=True)
    bg = rgb[..., -1, :] if m["background_color"] == "last_sample" else torch.ones_like(acc_rgb)
    rgb_out = torch.clamp(acc_rgb + bg * (1.0 - acc), 0.0, 1.0)
    x = torch.sum(w.detach()[..., None] * sem, dim=-2)[..., 0]
    losses = {
        "rgb_loss": torch.mean((rgb_out - rgb_gt) ** 2),
        "semantics_loss": m["semantic_loss_weight"] * torch.mean(
            torch.clamp_min(x, 0.0) - x * mask_gt + torch.log1p(torch.exp(-torch.abs(x)))),
        "interlevel_loss": m["interlevel_loss_mult"] * RM.interlevel(weights_list, sdist_list),
    }
    if m["use_distortion_loss"]:
        raise NotImplementedError("the distortion loss is not in any configuration's loss")
    if m["density_sparsity_mult"] > 0:
        pts = draws["sparse"]
        occ = 1.0 - torch.exp(-get_density(params["model"]["field"], pts, field, lower)
                              * m["sparsity_cell"])
        if m["sparsity_unobserved_boost"] > 1.0:
            cov = RM.frustum_coverage(cams, pts, data["train_indices"])
            occ = occ * torch.where(cov > 0, 1.0, m["sparsity_unobserved_boost"])
        losses["sparsity_loss"] = m["density_sparsity_mult"] * torch.mean(occ)
    return sum(losses.values()), losses
