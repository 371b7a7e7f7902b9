"""The initial parameters of a cell, made by the benchmark from the seed: the
program is handed them, and the reference makes the same again.

The tree is the one the port's train state takes (``init_train_state(...,
params=)``): ``{"model": {"field": {...}, "proposal_networks": [...]},
"camera_opt": [N, 6]}``. Tables are uniform in +-1e-4 (instant-ngp's), MLP
weights He-uniform with zero biases, appearance embeddings standard normal,
camera-opt zero: the distributions of a fresh run. They are made on the
device in two calls, one uniform and one normal, each over every scene.
"""
from __future__ import annotations

import torch

from . import layout as LY
from .reference.model import field_encoding, mlp_dims, proposal_mlp_dims, table_key


def leaf_specs(cfg: dict, num_images: int) -> list[tuple[tuple, tuple, str, float]]:
    """[(tree path, shape, kind, scale)] of every parameter; kind is
    "table" (uniform +-scale), "he" (uniform +-scale), "normal" or "zero"."""
    field = cfg["model"]["field"]
    out = []

    def add_mlp(prefix, dims):
        d_in, nl, hid, d_out, _ = dims
        ds = [d_in] + [hid] * (nl - 1) + [d_out]
        for i in range(nl):
            out.append(((*prefix, f"w{i}"), (ds[i], ds[i + 1]), "he", (6.0 / ds[i]) ** 0.5))
            out.append(((*prefix, f"b{i}"), (ds[i + 1],), "zero", 0.0))

    tk = table_key(field)
    if tk is not None:
        lay = LY.encoding_layout(field_encoding(field))
        out.append((("model", "field", tk), (lay.total_rows, lay.width), "table", 1e-4))
    for name, dims in mlp_dims(field).items():
        add_mlp(("model", "field", name), dims)
    out.append((("model", "field", "appearance"), (num_images, field["appearance_embed_dim"]),
                "normal", 1.0))
    for j, net in enumerate(cfg["model"]["proposal_nets"]):
        if net["kind"] == "hash":
            lay = LY.encoding_layout(net["hash"])
            out.append((("model", "proposal_networks", j, "hash_table"),
                        (lay.total_rows, lay.width), "table", 1e-4))
        add_mlp(("model", "proposal_networks", j, "mlp"), proposal_mlp_dims(net))
    out.append((("camera_opt",), (num_images, 6), "zero", 0.0))
    return out


def _put(tree: dict, path: tuple, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make(cfg: dict, num_images: int, seed: int, device, scenes: int | None = None) -> dict:
    """The parameter tree from ``seed``; with ``scenes``, every leaf leads
    with a scene axis of that size (scene s's parameters differ from scene
    t's)."""
    specs = leaf_specs(cfg, num_images)
    s = 1 if scenes is None else scenes
    numel = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_u = sum(n for n, (_, _, kind, _) in zip(numel, specs) if kind in ("table", "he"))
    n_n = sum(n for n, (_, _, kind, _) in zip(numel, specs) if kind == "normal")
    uni = torch.rand((s, n_u), generator=gen, device=device)
    nrm = torch.randn((s, n_n), generator=gen, device=device)
    tree: dict = {}
    iu = inn = 0
    for n, (path, shape, kind, scale) in zip(numel, specs):
        full = (s, *shape)
        if kind in ("table", "he"):
            t = (uni[:, iu : iu + n] * (2.0 * scale) - scale).reshape(full)
            iu += n
        elif kind == "normal":
            t = nrm[:, inn : inn + n].reshape(full).clone()
            inn += n
        else:
            t = torch.zeros(full, device=device)
        _put(tree, path, t if scenes is not None else t[0].contiguous())
    return tree
