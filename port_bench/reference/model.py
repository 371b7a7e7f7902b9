"""The plain reference of one train step of the semantic NeRF, in plain
PyTorch, driven by a configuration file's ``config`` section alone.

Frozen copy of the mathematics of ``fruitnerf_tpu_torch``'s
``engine/trainer.py`` (``draw_step``, ``compute_loss``, ``_sparsity_loss``),
``models/fruit_model.py``, ``core/{samplers,render,losses,rays,math}.py``,
``cameras/{cameras,camera_opt}.py``, ``fields/{fruit_field,density_field,
freq_density_field,mlp,encodings}.py`` and the plain encodings of
``ops/hash_grid.py`` (``cell_encode_torch``, ``grid_encode_corner_torch``),
as of the benchmark's first version. It imports nothing of the port and
nothing of JAX. Each grid encoding is a gather of its rows and trilinear
weights, a level at a time, so that a huge step's 8.4 M proposal samples
fit; autograd gives every gradient.

``lower`` selects the control: False computes as the configuration
states (MLP matmuls in its ``compute_dtype``, the rest in float32; the
caller turns TF32 off); True computes every MLP matmul on operands rounded
to float8 e4m3 (scaled per tensor, the step below bfloat16) and every grid
encoding from a bfloat16 table (the step below float32).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import layout as LY

_EPS = torch.finfo(torch.float32).eps


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


class TruncExp(torch.autograd.Function):
    """exp with the forward's exponent clipped at +-30, the backward's at +-15."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, -30.0, 30.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def contract_to_unit(x):
    """Mip-NeRF-360 L-inf contraction to (-2, 2)^3, mapped to [0,1]^3; points
    outside the open unit cube are zeroed and deselected."""
    mag = torch.clamp_min(torch.amax(torch.abs(x), dim=-1, keepdim=True), 1e-12)
    contracted = (2.0 - 1.0 / mag) * (x / mag)
    pos = (torch.where(mag <= 1.0, x, contracted) + 2.0) / 4.0
    selector = torch.all((pos > 0.0) & (pos < 1.0), dim=-1)
    return pos * selector[..., None], selector


def take_sorted(vals, idx):
    v, i = vals.reshape(-1, vals.shape[-1]), idx.reshape(-1, idx.shape[-1])
    rows = torch.arange(v.shape[0], device=v.device)[:, None]
    return v[rows, i].reshape(idx.shape)


def searchsorted(a, v):
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=True)


def _fp8(x):
    """x rounded to float8 e4m3 at a per-tensor scale (amax to 448)."""
    scale = torch.clamp_min(x.detach().abs().amax().float(), 1e-30) / 448.0
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.float()).to(x.dtype).detach()  # rounded forward, straight-through backward


def mlp(params, x, num_layers, out_sigmoid, dtype, lower):
    """ReLU MLP on [..., d_in] in ``dtype``; float32 out."""
    shape = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1]).to(dtype)
    for i in range(num_layers):
        w, b = params[f"w{i}"].to(dtype), params[f"b{i}"].to(dtype)
        if lower:
            h, w = _fp8(h), _fp8(w)
        h = h @ w + b
        if i < num_layers - 1:
            h = torch.relu(h)
    h = h.float().reshape(*shape, h.shape[-1])
    return torch.sigmoid(h) if out_sigmoid else h


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------


def _trilinear(frac):
    """[P, 3] fractions -> [P, 8] corner weights (corner c = 4cx + 2cy + cz)."""
    dev = frac.device
    bits = [torch.tensor(b, dtype=torch.bool, device=dev) for b in (LY.CX, LY.CY, LY.CZ)]
    tx, ty, tz = (frac[:, a : a + 1] for a in range(3))
    return torch.where(bits[0], tx, 1.0 - tx) * torch.where(bits[1], ty, 1.0 - ty) \
        * torch.where(bits[2], tz, 1.0 - tz)


def grid_encode(table, pos, lay: LY.Layout, lower: bool, record=None, name=""):
    """table [sum T_l, width], positions [P, 3] in [0,1]^3 -> [P, L*F]
    float32, level-major. A row index outside its level reads zero."""
    if record is not None:
        record.append((name, lay, pos.detach()))
    if lower:
        table = table.to(torch.bfloat16)
    outs = []
    for lvl in range(lay.num_levels):
        rows, valid, frac = LY.lookups(pos, lay, lvl)
        w8 = _trilinear(frac)  # [P, 8]
        if lower:
            w8 = w8.to(torch.bfloat16)
        r = table[rows]  # cell: [P, 16]; corner: [P, 8, F]
        r = torch.where(valid[..., None], r, torch.zeros_like(r))
        if lay.corner:
            outs.append((r * w8[..., None]).sum(-2).float())
        else:
            outs.append((r.view(-1, 8, 2) * w8[..., None]).sum(-2).float())
    return torch.cat(outs, dim=-1)


def sh_encode(d, levels: int = 4):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [0.28209479177387814 * torch.ones_like(x)]
    if levels > 1:
        comps += [0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x]
    if levels > 2:
        comps += [1.0925484305920792 * xy, 1.0925484305920792 * yz,
                  0.9461746957575601 * zz - 0.31539156525252005, 1.0925484305920792 * xz,
                  0.5462742152960396 * (xx - yy)]
    if levels > 3:
        comps += [0.5900435899266435 * y * (3.0 * xx - yy), 2.890611442640554 * xy * z,
                  0.4570457994644658 * y * (5.0 * zz - 1.0),
                  0.3731763325901154 * z * (5.0 * zz - 3.0),
                  0.4570457994644658 * x * (5.0 * zz - 1.0), 1.445305721320277 * z * (xx - yy),
                  0.5900435899266435 * x * (xx - 3.0 * yy)]
    return torch.stack(comps, dim=-1)


def nerf_encode(x, num_frequencies: int):
    freqs = math.pi * 2.0 ** torch.linspace(0.0, num_frequencies - 1, num_frequencies,
                                            dtype=x.dtype, device=x.device)
    scaled = (x[..., :, None] * freqs).flatten(-2)
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------


def field_encoding(field: dict) -> dict | None:
    return {"grid": field["grid"], "hash": field["hash"], "freq": None}[field["encoding"]]


def table_key(field: dict) -> str | None:
    return {"grid": "grid_table", "hash": "hash_table", "freq": None}[field["encoding"]]


def mlp_dims(field: dict) -> dict:
    """{mlp name: (d_in, num_layers, hidden, d_out, sigmoid)} of a FruitField."""
    enc = field_encoding(field)
    if field["encoding"] == "freq":
        base_in, base_layers = 3 + 6 * field["pos_frequencies"], max(field["num_layers_base"], 4)
    else:
        base_in, base_layers = enc["num_levels"] * enc["features_per_level"], \
            field["num_layers_base"]
    g, hs = field["geo_feat_dim"], field["hidden_dim_semantic"]
    return {
        "base_mlp": (base_in, base_layers, field["hidden_dim"], 1 + g, False),
        "color_mlp": (field["sh_levels"] ** 2 + g + field["appearance_embed_dim"],
                      field["num_layers_color"], field["hidden_dim_color"], 3, True),
        "semantic_mlp": (g, field["num_layers_semantic"], hs, hs, False),
        "semantic_head": (hs, 1, hs, field["num_semantic_classes"], False),
    }


def proposal_mlp_dims(net: dict) -> tuple:
    if net["kind"] == "freq":
        return (3 + 6 * net["num_frequencies"], net["num_layers"], net["hidden_dim"], 1, False)
    h = net["hash"]
    return (h["num_levels"] * h["features_per_level"], 1 if net["use_linear"] else net["num_layers"],
            net["hidden_dim"], 1, False)


def get_density(params, positions, field, lower, record=None, name="field"):
    pos01, selector = contract_to_unit(positions)
    dims = mlp_dims(field)
    if field["encoding"] == "freq":
        h = nerf_encode(pos01 * 2.0 - 1.0, field["pos_frequencies"])
    else:
        lay = LY.encoding_layout(field_encoding(field))
        h = grid_encode(params[table_key(field)], pos01.reshape(-1, 3), lay, lower, record, name)
        h = h.reshape(*positions.shape[:-1], -1)
    d_in, nl, _, _, sig = dims["base_mlp"]
    out = mlp(params["base_mlp"], h, nl, sig, dtype_of(field["compute_dtype"]), lower)
    density = TruncExp.apply(out[..., 0] + field["density_bias"]) * selector
    return density, out[..., 1:]


def field_forward(params, positions, directions, camera_indices, field, lower, record):
    density, geo = get_density(params, positions, field, lower, record, "field")
    r, s = positions.shape[0], positions.shape[1]
    dims, dt = mlp_dims(field), dtype_of(field["compute_dtype"])
    sh = sh_encode(directions, field["sh_levels"])[:, None, :].expand(r, s, -1)
    app = params["appearance"][camera_indices][:, None, :].expand(r, s, -1)
    rgb = mlp(params["color_mlp"], torch.cat([sh, geo, app], dim=-1),
              dims["color_mlp"][1], True, dt, lower)
    sem_h = mlp(params["semantic_mlp"], geo.detach(), dims["semantic_mlp"][1], False, dt, lower)
    sem = mlp(params["semantic_head"], sem_h, 1, False, dt, lower)
    return density, rgb, sem


def proposal_forward(params, positions, net, lower, record, name):
    pos01, selector = contract_to_unit(positions)
    d_in, nl, _, _, _ = proposal_mlp_dims(net)
    dt = dtype_of(net["compute_dtype"])
    if net["kind"] == "freq":
        h = nerf_encode(pos01 * 2.0 - 1.0, net["num_frequencies"])
    else:
        lay = LY.encoding_layout(net["hash"])
        h = grid_encode(params["hash_table"], pos01.reshape(-1, 3), lay, lower, record, name)
        h = h.reshape(*positions.shape[:-1], -1)
    out = mlp(params["mlp"], h, nl, False, dt, lower)
    return TruncExp.apply(out[..., 0]) * selector


# ---------------------------------------------------------------------------
# cameras and rays
# ---------------------------------------------------------------------------


def exp_map_so3xr3(tangent):
    omega, t = tangent[..., :3], tangent[..., 3:]
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta_sq < 1e-10
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    z = torch.zeros_like(omega[..., 0])
    k = torch.stack([
        torch.stack([z, -omega[..., 2], omega[..., 1]], dim=-1),
        torch.stack([omega[..., 2], z, -omega[..., 0]], dim=-1),
        torch.stack([-omega[..., 1], omega[..., 0], z], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(k.shape)
    rot = eye + a[..., None] * k + b[..., None] * (k @ k)
    return torch.cat([rot, t[..., :, None]], dim=-1)


def undistort(coords, dist):
    k1, k2, k3, k4, p1, p2 = dist.unbind(-1)
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
        x, y = x + (xd - dx), y + (yd - dy)
    return torch.stack([x, y], dim=-1)


def generate_rays(cams, ci, py, px, adj):
    x = (px.float() + 0.5 - cams["cx"][ci]) / cams["fx"][ci]
    y = (py.float() + 0.5 - cams["cy"][ci]) / cams["fy"][ci]
    coords = torch.stack([x, y], dim=-1)
    dist = cams["distortion"][ci]
    coords = torch.where(torch.any(torch.abs(dist) > 0.0, dim=-1, keepdim=True),
                         undistort(coords, dist), coords)
    dirs_cam = torch.stack([coords[..., 0], -coords[..., 1], -torch.ones_like(coords[..., 0])],
                           dim=-1)
    c2w = cams["camera_to_worlds"][ci]
    origins = c2w[..., :3, 3]
    directions = torch.einsum("rij,rj->ri", c2w[..., :3, :3], dirs_cam)
    if adj is not None:
        a = adj[ci]
        directions = torch.einsum("rij,rj->ri", a[..., :3, :3], directions)
        origins = origins + a[..., :3, 3]
    directions = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    return origins, directions


def frustum_coverage(cams, points, idx, near=1e-3):
    c2w = cams["camera_to_worlds"][idx]
    fx, fy, cx, cy = (cams[k][idx] for k in ("fx", "fy", "cx", "cy"))
    w, h = cams["width"].float()[idx], cams["height"].float()[idx]
    rel = points[None, :, :] - c2w[:, :, 3][:, None, :]
    pc = torch.einsum("nij,npi->npj", c2w[:, :, :3], rel)
    depth = -pc[..., 2]
    safe = torch.clamp_min(depth, 1e-9)
    u = pc[..., 0] / safe * fx[:, None] + cx[:, None]
    v = pc[..., 1] / (-safe) * fy[:, None] + cy[:, None]
    inside = (depth > near) & (u >= 0.0) & (u <= w[:, None]) & (v >= 0.0) & (v <= h[:, None])
    return torch.sum(inside, dim=0)


# ---------------------------------------------------------------------------
# sampling, rendering, losses
# ---------------------------------------------------------------------------


def _spacing(name):
    if name == "uniform":
        return (lambda t: t), (lambda s: s)
    fn = lambda t: torch.where(t < 1.0, t / 2.0, 1.0 - 1.0 / (2.0 * torch.clamp_min(t, 1e-12)))
    inv = lambda s: torch.where(s < 0.5, 2.0 * s, 1.0 / torch.clamp_min(2.0 - 2.0 * s, 1e-12))
    return fn, inv


class Samples:
    """Bins of a ray batch: normalized edges s_bins [R, S+1], euclidean t."""

    def __init__(self, origins, dirs, nears, fars, s_bins, spacing):
        fn, inv = _spacing(spacing)
        s_near, s_far = fn(nears)[:, None], fn(fars)[:, None]
        t = inv(s_bins * s_far + (1.0 - s_bins) * s_near)
        self.origins, self.dirs, self.s_bins = origins, dirs, s_bins
        self.starts, self.ends = t[:, :-1], t[:, 1:]

    def positions(self):
        mid = 0.5 * (self.starts + self.ends)
        return self.origins[:, None, :] + self.dirs[:, None, :] * mid[..., None]

    def weights(self, density):
        dd = density * (self.ends - self.starts)
        alphas = 1.0 - torch.exp(-dd)
        trans = torch.exp(-torch.cumsum(dd, dim=-1) + dd)
        return alphas * trans


def pdf_bins(s_bins, weights, n, u_draw, pad=0.01):
    nb = n + 1
    w = weights + pad
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.clamp_min(1e-5 - w_sum, 0.0)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding
    pdf = w / w_sum
    cdf = torch.clamp_max(torch.cumsum(pdf[:, :-1], dim=-1), 1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], dim=-1)
    u = torch.linspace(0.0, 1.0 - 1.0 / nb, nb, device=s_bins.device)
    u = u.expand(s_bins.shape[0], nb) + u_draw / nb
    inds = searchsorted(cdf, u)
    below = torch.clamp(inds - 1, 0, cdf.shape[-1] - 1)
    above = torch.clamp(inds, 0, cdf.shape[-1] - 1)
    c0, c1 = take_sorted(cdf, below), take_sorted(cdf, above)
    b0, b1 = take_sorted(s_bins, below), take_sorted(s_bins, above)
    t = torch.clamp((u - c0) / torch.clamp_min(c1 - c0, 1e-12), 0.0, 1.0)
    return b0 + t * (b1 - b0)


def outer_measure(t0s, t0e, t1s, t1e, y1):
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    last = y1.shape[-1] - 1
    lo = torch.clamp(searchsorted(t1s, t0s) - 1, 0, last)
    hi = torch.clamp(searchsorted(t1e, t0e), 0, last)
    return take_sorted(cy1[..., 1:], hi) - take_sorted(cy1[..., :-1], lo)


def interlevel(weights_list, sdist_list):
    c, w = sdist_list[-1].detach(), weights_list[-1].detach()
    loss = 0.0
    for sd, wp in zip(sdist_list[:-1], weights_list[:-1]):
        w_outer = outer_measure(c[..., :-1], c[..., 1:], sd[..., :-1], sd[..., 1:], wp)
        loss = loss + torch.mean(torch.clamp_min(w - w_outer, 0.0) ** 2 / (w + _EPS))
    return loss


def proposal_updated(step: int, m: dict) -> bool:
    mm = np.float32(step) / np.float32(m["proposal_warmup"]) * np.float32(m["proposal_update_every"])
    mm = min(max(mm, np.float32(1.0)), np.float32(m["proposal_update_every"]))
    return step < 10 or step % max(int(np.round(mm)), 1) == 0


def proposal_anneal(step: int, m: dict) -> float:
    if not m["use_proposal_weight_anneal"]:
        return 1.0
    x = np.clip(np.float32(step) / np.float32(m["proposal_weights_anneal_max_num_iters"]),
                0.0, 1.0).astype(np.float32)
    b = np.float32(m["proposal_weights_anneal_slope"])
    return float(b * x / ((b - np.float32(1.0)) * x + np.float32(1.0)))


def sampler_draw_shapes(m: dict, r: int):
    if m["use_single_jitter"]:
        return [(r, 1)] * (len(m["proposal_nets"]) + 1)
    counts = (*m["num_proposal_samples"][1:], m["num_nerf_samples"])
    return [(r, m["num_proposal_samples"][0] + 1)] + [(r, n + 1) for n in counts]


# ---------------------------------------------------------------------------
# the step's draws and loss
# ---------------------------------------------------------------------------


def draw_step(cfg: dict, num_train: int, hw, gen, device):
    """The draws of one step, in the order the program's step makes them
    from its generator."""
    r, m = cfg["train_rays_per_batch"], cfg["model"]
    h, w = hw

    def randint(high):
        return torch.randint(0, high, (r,), generator=gen, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    slot = randint(num_train)
    py, px = randint(h), randint(w)
    jitter = rand(2, r) - 0.5
    sampler = [rand(*s) for s in sampler_draw_shapes(m, r)]
    ext = m["sparsity_extent"]
    sparse = rand(m["sparsity_num_points"], 3) * (2.0 * ext) - ext
    return dict(slot=slot, py=py, px=px, jitter=jitter, sampler=sampler, sparse=sparse)


def loss(params, data: dict, cfg: dict, draws: dict, step: int, lower=False,
         record=None, keep=None):
    """-> (total loss, {loss name: value}) of one step, as the program
    computes it. ``keep`` (a bool [R] mask, or None) trains on those rays
    alone: a planted fault."""
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
    adj = exp_map_so3xr3(params["camera_opt"]) if cfg["use_camera_opt"] else None
    origins, dirs = generate_rays(cams, cam, ray_y, ray_x, adj)
    uniforms = draws["sampler"]
    if keep is not None:
        origins, dirs, cam, rgb_gt, mask_gt = (t[keep] for t in (origins, dirs, cam, rgb_gt,
                                                                  mask_gt))
        uniforms = [u[keep] for u in uniforms]
    r = origins.shape[0]
    nears = torch.full((r,), m["near_plane"], device=origins.device)
    fars = torch.full((r,), m["far_plane"], device=origins.device)
    updated = proposal_updated(step, m)
    anneal = proposal_anneal(step, m)
    spacing = m["proposal_initial_sampler"]

    n0 = m["num_proposal_samples"][0]
    edges = torch.linspace(0.0, 1.0, n0 + 1, device=origins.device).expand(r, n0 + 1)
    centers = (edges[:, 1:] + edges[:, :-1]) / 2.0
    upper = torch.cat([centers, edges[:, -1:]], dim=-1)
    lower_e = torch.cat([edges[:, :1], centers], dim=-1)
    s_bins = lower_e + (upper - lower_e) * uniforms[0]
    samples = Samples(origins, dirs, nears, fars, s_bins, spacing)
    weights_list, sdist_list = [], []
    nets = m["proposal_nets"]
    for i, net in enumerate(nets):
        d = proposal_forward(params["model"]["proposal_networks"][i], samples.positions(), net,
                             lower, record, f"proposal{i}")
        if not updated:
            d = d.detach()
        w = samples.weights(d)
        annealed = torch.pow(torch.clamp_min(w, 1e-12), anneal)
        weights_list.append(w)
        sdist_list.append(samples.s_bins)
        n_next = m["num_proposal_samples"][i + 1] if i + 1 < len(nets) else m["num_nerf_samples"]
        new_bins = pdf_bins(samples.s_bins, annealed, n_next, uniforms[i + 1])
        samples = Samples(origins, dirs, nears, fars, new_bins, spacing)
    density, rgb, sem = field_forward(params["model"]["field"], samples.positions(), dirs, cam,
                                      field, lower, record)
    w = samples.weights(density)
    weights_list.append(w)
    sdist_list.append(samples.s_bins)
    acc_rgb = torch.sum(w[..., None] * rgb, dim=-2)
    acc = torch.sum(w, dim=-1, keepdim=True)
    if m["background_color"] == "last_sample":
        bg = rgb[..., -1, :]
    else:
        bg = torch.ones_like(acc_rgb)
    rgb_out = torch.clamp(acc_rgb + bg * (1.0 - acc), 0.0, 1.0)
    sem_logit = torch.sum(w.detach()[..., None] * sem, dim=-2)[..., 0]
    x, y = sem_logit, mask_gt
    losses = {
        "rgb_loss": torch.mean((rgb_out - rgb_gt) ** 2),
        "semantics_loss": m["semantic_loss_weight"] * torch.mean(
            torch.clamp_min(x, 0.0) - x * y + torch.log1p(torch.exp(-torch.abs(x)))),
        "interlevel_loss": m["interlevel_loss_mult"] * interlevel(weights_list, sdist_list),
    }
    if m["use_distortion_loss"]:
        raise NotImplementedError("the distortion loss is not in any configuration's loss")
    if m["density_sparsity_mult"] > 0:
        pts = draws["sparse"]
        dens, _ = get_density(params["model"]["field"], pts, field, lower, record, "sparsity")
        occ = 1.0 - torch.exp(-dens * m["sparsity_cell"])
        if m["sparsity_unobserved_boost"] > 1.0:
            cov = frustum_coverage(cams, pts, data["train_indices"])
            occ = occ * torch.where(cov > 0, 1.0, m["sparsity_unobserved_boost"])
        losses["sparsity_loss"] = m["density_sparsity_mult"] * torch.mean(occ)
    total = sum(losses.values())
    return total, losses
