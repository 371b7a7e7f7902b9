"""The CUDA kernels (cell_encode, corner_encode, and the cell-v1 route of
grid_encode_flat) against their plain PyTorch versions, on a card: the
tiled kernels also at ray-ordered points, with every point in one cell
(and the corner kernels at hash collisions inside a warp and at F = 1 to
8), at 1 to 32 levels and at a P that is no multiple of their tile; the
corner kernels at the parity variant's and the huge preset's hash layouts
through ``hash_encode`` (and at a huge step's 8,388,608 points), the cell
kernels at the big preset's layout through ``grid_encode``; two training
runs from one seed, which must be bitwise equal; and the disk
capture workflow on the card: ``train --data <capture>`` launches K1/K2 as
predicted, ``eval`` and ``render`` run on the card by default, and LPIPS
there equals LPIPS on the CPU; the scene axis: K1-K4 at S = 4 bitwise
equal to single launches, a multi-scene step on the card against the CPU,
two gloo ranks sharing the card against one. Every test
here is marked ``gpu`` and skips without one.
This file imports no JAX, so it runs on the GPU machine, which has none:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)"""

import numpy as np
import pytest
import torch

from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig
from fruitnerf_tpu_torch.ops import hash_grid as hg

FWD_ATOL = 1e-5  # float32 sums of 8 products of O(1) values
BWD_RTOL = 1e-4  # relative to each gradient's max; the sums' orders and roundings differ

pytestmark = pytest.mark.gpu

# a direct level whose grid fills its table (8^3 = 512 rows), then hashed
# levels up to res 2048
GRID = GridEncodingConfig(num_levels=4, table_size=512, base_res=8, max_res=2048)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(dev, n=3000):
    layout = GRID.cell_layout()
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((layout.total_rows, 16), generator=g, device=dev) * 2 - 1
    pos = torch.rand((n, 3), generator=g, device=dev)
    pos[0] = torch.tensor([0.5, 0.5, 1.0])  # past the direct level's table
    grad = torch.randn((n, 2 * layout.num_levels), generator=g, device=dev)
    return layout, table, pos, grad


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_kernels_match_plain(dev):
    layout, table, pos, grad = _inputs(dev)
    assert GRID.level_layout()[0] == (512, 512, 1, True)
    out = hg.cell_encode_fwd_cuda(table, pos, layout)
    ref = hg.cell_encode_torch(table, pos, layout)
    torch.testing.assert_close(out, ref, atol=FWD_ATOL, rtol=0)
    assert float(out[0, :2].abs().max()) == 0.0  # the zero row
    dt, dp = hg.cell_encode_bwd_cuda(table, pos, grad, layout, True)
    t_ = table.clone().requires_grad_(True)
    p_ = pos.clone().requires_grad_(True)
    hg.cell_encode_torch(t_, p_, layout).backward(grad)
    assert _rel(dt, t_.grad) <= BWD_RTOL
    assert _rel(dp, p_.grad) <= BWD_RTOL


def test_autograd_function_and_launch_counts(dev):
    """One forward and one backward launch per call; dPositions only when
    the positions need a gradient."""
    layout, table, pos, grad = _inputs(dev)
    t_ = table.clone().requires_grad_(True)
    before = dict(hg.LAUNCHES)
    hg.cell_encode(t_, pos, layout).backward(grad)
    assert hg.LAUNCHES["cell_encode_fwd"] == before["cell_encode_fwd"] + 1
    assert hg.LAUNCHES["cell_encode_bwd"] == before["cell_encode_bwd"] + 1
    p_ = pos.clone().requires_grad_(True)
    t2 = table.clone().requires_grad_(True)
    hg.cell_encode(t2, p_, layout).backward(grad)
    torch.testing.assert_close(t2.grad, t_.grad, atol=BWD_RTOL * float(t_.grad.abs().max()),
                               rtol=0)
    assert p_.grad is not None and bool(torch.isfinite(p_.grad).all())


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    layout, table, pos, grad = _inputs(dev)
    with pytest.raises(TypeError, match="float32"):
        hg.cell_encode_fwd_cuda(table.double(), pos, layout)
    with pytest.raises(ValueError, match="shape"):
        hg.cell_encode_fwd_cuda(table[:-1], pos, layout)
    with pytest.raises(ValueError, match="contiguous"):
        hg.cell_encode_fwd_cuda(table, pos.t().contiguous().t(), layout)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(layout.total_rows * 16 + 1, device=dev)
        hg.cell_encode_fwd_cuda(flat[1:].view(layout.total_rows, 16), pos, layout)
    with pytest.raises(ValueError, match="table on"):
        hg.cell_encode(table, pos.cpu(), layout)


def _levels(num_levels):
    """The preset's shape at ``num_levels`` levels: res 16..2048, a direct
    level 0 (16^3 = 4096 rows), hashed levels of 4096 rows."""
    res = [16] if num_levels == 1 else [
        int(16 * (2048 / 16) ** (l / (num_levels - 1))) for l in range(num_levels)]
    return hg.CellLayout.from_levels(res, hg.cell_level_layout(res, 4096, 128))


def _points(dev, g, kind, n_rays=64, samples=48, extra=13):
    """P = 64 x 48 + 13 points (not a multiple of the kernels' 32-point
    tile). "ray_ordered": 48 consecutive samples along each ray, as a train
    step orders them; "one_cell": every point in one level-0 cell (the
    worst contention). Point 5 sits at z = 1.0, past level 0's table."""
    p = n_rays * samples + extra
    if kind == "one_cell":
        pos = 0.5 + 0.01 * torch.rand((p, 3), generator=g, device=dev)
    else:
        origin = 0.2 + 0.6 * torch.rand((n_rays, 1, 3), generator=g, device=dev)
        d = torch.randn((n_rays, 1, 3), generator=g, device=dev)
        t = torch.sort(torch.rand((n_rays, samples, 1), generator=g, device=dev), dim=1).values
        ray = (origin + 0.15 * t * d / d.norm(dim=-1, keepdim=True)).clamp(0.0, 0.999)
        pos = torch.cat([ray.reshape(-1, 3), torch.rand((extra, 3), generator=g, device=dev)])
    pos[5] = torch.tensor([0.5, 0.5, 1.0])
    return pos.contiguous()


@pytest.mark.parametrize("kind", ["ray_ordered", "one_cell"])
@pytest.mark.parametrize("num_levels", [1, 5, 16, 32])
def test_tiled_cell_kernels_match_plain(dev, num_levels, kind):
    """The tiled K1/K2 (a warp a level, a lane a point, runs of lanes on one
    row merged before their fixed-point adds) against the plain version,
    with and without dPositions; the second backward repeats the first's
    dTable bitwise."""
    layout = _levels(num_levels)
    assert layout.direct[0] and layout.rows[0] == 4096
    g = torch.Generator(device=dev).manual_seed(num_levels)
    table = torch.rand((layout.total_rows, 16), generator=g, device=dev) * 2 - 1
    pos = _points(dev, g, kind)
    grad = torch.randn((pos.shape[0], 2 * num_levels), generator=g, device=dev)
    out = hg.cell_encode_fwd_cuda(table, pos, layout)
    torch.testing.assert_close(out, hg.cell_encode_torch(table, pos, layout), atol=FWD_ATOL,
                               rtol=0)
    assert float(out[5, :2].abs().max()) == 0.0  # the zero row
    t_ = table.clone().requires_grad_(True)
    p_ = pos.clone().requires_grad_(True)
    hg.cell_encode_torch(t_, p_, layout).backward(grad)
    dt, dp = hg.cell_encode_bwd_cuda(table, pos, grad, layout, True)
    assert _rel(dt, t_.grad) <= BWD_RTOL and _rel(dp, p_.grad) <= BWD_RTOL
    dt_only, none = hg.cell_encode_bwd_cuda(table, pos, grad, layout, False)
    assert none is None and torch.equal(dt_only, dt)


# corner mode: a direct level whose corners fill their table (8^3 = 512
# entries at res 7), then hashed levels up to res 2048
CORNER_RES = (7, 64, 1024, 2048)
CORNER_T = 512


def _corner_inputs(dev, features, n=3000):
    layout = hg.corner_layout(CORNER_RES, CORNER_T)
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.rand((layout.total_rows, features), generator=g, device=dev) * 2 - 1
    pos = torch.rand((n, 3), generator=g, device=dev)
    pos[0] = torch.tensor([0.5, 0.5, 1.0])  # its +z corners index past level 0's table
    grad = torch.randn((n, features * layout.num_levels), generator=g, device=dev)
    return layout, table, pos, grad


@pytest.mark.parametrize("features", [2, 4])
def test_corner_kernels_match_plain(dev, features):
    layout, table, pos, grad = _corner_inputs(dev, features)
    assert layout.direct == (True, False, False, False)
    out = hg.corner_encode_fwd_cuda(table, pos, layout, features)
    ref = hg.grid_encode_corner_torch(table, pos, layout, features)
    torch.testing.assert_close(out, ref, atol=FWD_ATOL, rtol=0)
    dt, dp = hg.corner_encode_bwd_cuda(table, pos, grad, layout, features, True)
    t_ = table.clone().requires_grad_(True)
    p_ = pos.clone().requires_grad_(True)
    hg.grid_encode_corner_torch(t_, p_, layout, features).backward(grad)
    assert _rel(dt, t_.grad) <= BWD_RTOL
    assert _rel(dp, p_.grad) <= BWD_RTOL


def _corner_levels(num_levels):
    """The corner slice's shape at ``num_levels`` levels: res 16..2048, T =
    8192 corner entries a level, level 0 direct (17^3 = 4913 entries; at 32
    levels level 1 too), the finest hashed."""
    res = [16] if num_levels == 1 else [
        int(16 * (2048 / 16) ** (l / (num_levels - 1))) for l in range(num_levels)]
    return hg.corner_layout(res, 8192)


def _colliding_cells(res, t):
    """Two cells at a hashed level (res, T) whose corner-0 entries hash onto
    one row: -> two int [3] arrays."""
    cells = np.random.default_rng(res).integers(0, res - 1, (4 * t, 3))
    c = cells.astype(np.uint64)
    rows = (c[:, 0] ^ ((c[:, 1] * hg._P1) & hg._MASK32) ^ ((c[:, 2] * hg._P2) & hg._MASK32)) \
        & (t - 1)
    first = {}
    for i, r in enumerate(rows.tolist()):
        if r in first and (cells[first[r]] != cells[i]).any():
            return cells[first[r]], cells[i]
        first.setdefault(r, i)
    raise AssertionError("no collision among 4T cells")


def _corner_points(dev, g, kind, layout, n_rays=64, samples=48, extra=13):
    """P = 64 x 48 + 13 points (not a multiple of the kernels' 32-point
    tile), as ``_points`` makes them, and "collision": runs of three points
    in one finest-level cell, alternating between two cells whose corner-0
    entries hash onto one row there. Point 5 sits at z = 1.0, past the
    direct level 0's entries."""
    if kind != "collision":
        return _points(dev, g, kind, n_rays, samples, extra)
    p = n_rays * samples + extra
    res, t = layout.resolutions[-1], layout.rows[-1]
    a, b = _colliding_cells(res, t)
    pair = torch.tensor(np.stack([a, b]), dtype=torch.float32, device=dev)
    cell = pair[(torch.arange(p, device=dev) // 3) % 2]
    pos = (cell + 0.1 + 0.8 * torch.rand((p, 3), generator=g, device=dev)) / res
    pos[5] = torch.tensor([0.5, 0.5, 1.0])
    return pos.contiguous()


@pytest.mark.parametrize("features", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("num_levels", [1, 5, 16, 32])
@pytest.mark.parametrize("kind", ["ray_ordered", "one_cell", "collision"])
def test_tiled_corner_kernels_match_plain(dev, kind, num_levels, features):
    """The tiled K3/K4 (a warp a level, a lane a point, runs of lanes in one
    cell merged before their fixed-point adds) against the plain version,
    with and without dPositions; the second backward repeats the first's
    dTable bitwise."""
    layout = _corner_levels(num_levels)
    assert layout.direct[0] and (num_levels == 1 or not layout.direct[-1])
    g = torch.Generator(device=dev).manual_seed(100 * num_levels + features)
    table = torch.rand((layout.total_rows, features), generator=g, device=dev) * 2 - 1
    pos = _corner_points(dev, g, kind, layout)
    assert pos.shape[0] % 32 != 0
    grad = torch.randn((pos.shape[0], features * num_levels), generator=g, device=dev)
    out = hg.corner_encode_fwd_cuda(table, pos, layout, features)
    ref = hg.grid_encode_corner_torch(table, pos, layout, features)
    torch.testing.assert_close(out, ref, atol=FWD_ATOL, rtol=0)
    t_ = table.clone().requires_grad_(True)
    p_ = pos.clone().requires_grad_(True)
    hg.grid_encode_corner_torch(t_, p_, layout, features).backward(grad)
    dt, dp = hg.corner_encode_bwd_cuda(table, pos, grad, layout, features, True)
    assert _rel(dt, t_.grad) <= BWD_RTOL and _rel(dp, p_.grad) <= BWD_RTOL
    dt_only, none = hg.corner_encode_bwd_cuda(table, pos, grad, layout, features, False)
    assert none is None and torch.equal(dt_only, dt)


HUGE_P = 16384 * 512  # a fruit_nerf_huge step's samples in each proposal field


@pytest.mark.parametrize("family", ["cell", "corner", "corner at the huge step's P"])
def test_backward_sums_dtable_in_fixed_point(dev, family):
    """K2 and K4 sum dTable in 64-bit fixed point at a power-of-two scale
    a gradient column (csrc/fixed_sum.cuh), at every point in one cell (the
    most adds onto one entry): launches repeat bitwise; the scale follows
    the gradient's magnitude; a NaN in one column of the gradient makes that
    column of dTable NaN and leaves every other entry as it was; no points
    give a zero dTable. The last case puts HUGE_P = 8,388,608 points in the
    cell: the scale leaves the int64 sums their headroom there too."""
    g = torch.Generator(device=dev).manual_seed(5)
    huge = family.endswith("P")
    if family == "cell":
        layout = _levels(5)
        table = torch.rand((layout.total_rows, 16), generator=g, device=dev) * 2 - 1

        def bwd(t, p, gr):
            return hg.cell_encode_bwd_cuda(t, p, gr, layout, True)

        def plain(t, p):
            return hg.cell_encode_torch(t, p, layout)
    else:
        layout = _corner_levels(5)
        table = torch.rand((layout.total_rows, 2), generator=g, device=dev) * 2 - 1

        def bwd(t, p, gr):
            return hg.corner_encode_bwd_cuda(t, p, gr, layout, 2, True)

        def plain(t, p):
            return hg.grid_encode_corner_torch(t, p, layout, 2)
    pos = (_points(dev, g, "one_cell", n_rays=HUGE_P // 64, samples=64, extra=0) if huge
           else _points(dev, g, "one_cell"))
    grad = torch.randn((pos.shape[0], 2 * layout.num_levels), generator=g, device=dev)
    dt, dp = bwd(table, pos, grad)
    for _ in range(3):
        again = bwd(table, pos, grad)
        assert torch.equal(again[0], dt) and torch.equal(again[1], dp)
    for scale in (1e-20, 1e20):
        t_ = table.clone().requires_grad_(True)
        plain(t_, pos).backward(grad * scale)
        assert _rel(bwd(table, pos, grad * scale)[0], t_.grad) <= BWD_RTOL
    bad = grad.clone()
    bad[7, 3] = float("nan")  # level 1, feature 1
    dt_bad = bwd(table, pos, bad)[0]
    column = torch.zeros_like(dt, dtype=torch.bool)
    column[layout.offsets[1]:layout.offsets[1] + layout.rows[1], 1::2] = True
    assert dt_bad[column].isnan().all()
    assert torch.equal(dt_bad[~column], dt[~column])
    dt0, dp0 = bwd(table, pos[:0], grad[:0])
    assert dp0.shape == (0, 3) and not dt0.any()


def test_corner_autograd_function_and_launch_counts(dev):
    layout, table, pos, grad = _corner_inputs(dev, 2)
    t_ = table.clone().requires_grad_(True)
    p_ = pos.clone().requires_grad_(True)
    before = dict(hg.LAUNCHES)
    out = hg.grid_encode_flat(t_, p_, CORNER_RES, CORNER_T, 2, "corner")
    out.backward(grad)
    assert hg.LAUNCHES["corner_encode_fwd"] == before["corner_encode_fwd"] + 1
    assert hg.LAUNCHES["corner_encode_bwd"] == before["corner_encode_bwd"] + 1
    t2 = table.clone().requires_grad_(True)
    p2 = pos.clone().requires_grad_(True)
    hg.grid_encode_corner_torch(t2, p2, layout, 2).backward(grad)
    assert _rel(t_.grad, t2.grad) <= BWD_RTOL and _rel(p_.grad, p2.grad) <= BWD_RTOL
    with pytest.raises(ValueError, match="features"):
        hg.corner_encode_fwd_cuda(torch.zeros((layout.total_rows, 9), device=dev), pos,
                                  layout, 9)


def test_cell_v1_route_matches_plain(dev):
    """grid_encode_flat(mode="cell") launches the cell kernels at the
    uniform layout (direct where res^3 <= T)."""
    res, t = (8, 16, 1024), 512
    layout = hg.uniform_cell_layout(res, t)
    assert layout.direct == (True, False, False)
    g = torch.Generator(device=dev).manual_seed(2)
    table = torch.rand((layout.total_rows, 16), generator=g, device=dev) * 2 - 1
    pos = torch.rand((3000, 3), generator=g, device=dev)
    grad = torch.randn((3000, 2 * len(res)), generator=g, device=dev)
    t_ = table.clone().requires_grad_(True)
    p_ = pos.clone().requires_grad_(True)
    before = dict(hg.LAUNCHES)
    out = hg.grid_encode_flat(t_, p_, res, t, 2, "cell")
    out.backward(grad)
    assert hg.LAUNCHES["cell_encode_fwd"] == before["cell_encode_fwd"] + 1
    assert hg.LAUNCHES["cell_encode_bwd"] == before["cell_encode_bwd"] + 1
    t2 = table.clone().requires_grad_(True)
    p2 = pos.clone().requires_grad_(True)
    ref = hg.cell_encode_torch(t2, p2, layout)
    ref.backward(grad)
    torch.testing.assert_close(out, ref, atol=FWD_ATOL, rtol=0)
    assert _rel(t_.grad, t2.grad) <= BWD_RTOL and _rel(p_.grad, p2.grad) <= BWD_RTOL


EXPORT_FLIP_TOL = 1e-4  # a flipped probe's value lies within this (relative, min 1) of its threshold


def _probe_index(points, n):
    """Output-space points (x2 of world) -> flat probe index (ray * n + sample)."""
    w = points / 2.0
    i = ((w[:, 0] + 1.0) / 2.0 * (n - 1)).round().long()
    j = ((w[:, 1] + 1.0) / 2.0 * (n - 1)).round().long()
    k = ((w[:, 2] + 1.0) / 2.0 * n).floor().long()
    return (i * n + j) * n + k


def test_sample_volume_on_the_card_matches_the_cpu(dev, tmp_path):
    """A small export (N = 32 in two batches) on the card, one K1 launch a
    batch, against the same export on the CPU (the plain version): the same
    surviving probes up to flips within EXPORT_FLIP_TOL of a threshold, and
    the same points and colours."""
    import dataclasses

    import numpy as np

    from fruitnerf_tpu_torch.bridge import tree_map
    from fruitnerf_tpu_torch.configs import fruit_nerf
    from fruitnerf_tpu_torch.core.rays import RayBundle
    from fruitnerf_tpu_torch.export import volume_sampler as vs
    from fruitnerf_tpu_torch.models.fruit_model import forward_export, init_fruit_model

    n = 32
    m = fruit_nerf(4, compute_dtype=torch.float32).model
    model = dataclasses.replace(m, field=dataclasses.replace(m.field, grid=GRID))
    params = init_fruit_model(model, torch.Generator().manual_seed(0), "cpu")
    params["field"]["grid_table"] *= 1e4  # O(1) entries: the grid shapes the field
    origins, direction, far = vs.orthographic_ray_grid(vs.ExportConfig().aabb, n)
    r = origins.shape[0]
    bundle = RayBundle(torch.from_numpy(origins), torch.from_numpy(direction).expand(r, 3),
                       torch.zeros(r), torch.full((r,), far), torch.zeros(r, dtype=torch.int64))
    with torch.inference_mode():
        ref = forward_export(params, bundle, model, n, torch.tensor([[-1.0] * 3, [1.0] * 3]))
    dens, logit, prob = (ref[k].reshape(-1) for k in ("density", "semantics", "semantics_prob"))
    thr = [float(torch.quantile(v, q)) for v, q in ((logit, 0.3), (dens, 0.4), (prob, 0.5))]
    cfg = vs.ExportConfig(num_points_per_side=n, num_rays_per_batch=r // 2,
                          semantic_logit_threshold=thr[0], density_threshold=thr[1],
                          colormap_prob_threshold=thr[2])
    before = hg.LAUNCHES["cell_encode_fwd"]
    gpu = vs.sample_volume(tree_map(params, lambda t: t.to(dev)), model, cfg, 1.0,
                           tmp_path / "gpu", progress=False)
    assert hg.LAUNCHES["cell_encode_fwd"] == before + 2
    cpu = vs.sample_volume(params, model, cfg, 1.0, tmp_path / "cpu", progress=False)

    def near(v, t):
        return (v - t).abs() <= EXPORT_FLIP_TOL * max(1.0, abs(t))

    near_thr = {"density": near(dens, thr[1]),
                "semantic": near(dens, thr[1]) | near(logit, thr[0]),
                "semantic_colormap": near(dens, thr[1]) | near(prob, thr[2])}
    for name in vs.CLOUDS:
        g, c = gpu[name], cpu[name]
        assert 0.1 * n**3 <= len(c["points"]) <= 0.9 * n**3, name
        ig = _probe_index(torch.from_numpy(g["points"]), n).numpy()
        ic = _probe_index(torch.from_numpy(c["points"]), n).numpy()
        flipped = np.setxor1d(ig, ic)
        assert near_thr[name][torch.from_numpy(flipped)].all(), (name, flipped)
        assert len(flipped) <= 1e-3 * n**3
        common = np.intersect1d(ig, ic)
        rg, rc = np.searchsorted(ig, common), np.searchsorted(ic, common)
        np.testing.assert_allclose(g["points"][rg], c["points"][rc], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g["colors"][rg], c["colors"][rc], atol=1e-5, rtol=0)


def _hash_layouts():
    """(name, HashEncodingConfig) of the parity variant's three hash grids."""
    from fruitnerf_tpu_torch.configs import fruit_nerf

    m = fruit_nerf(1, variant="parity").model
    return [("main", m.field.hash)] + [(f"proposal{i}", p.hash)
                                       for i, p in enumerate(m.proposal_nets)]


@pytest.mark.parametrize("kind", ["random", "ray_ordered"])
@pytest.mark.parametrize("name", ["main", "proposal0", "proposal1"])
def test_corner_kernels_at_the_parity_layouts(dev, name, kind):
    """K3/K4 at the parity variant's layouts (the main field: 16 levels,
    T = 2^19, 5 direct levels, a 64 MiB table; each proposal field: 5
    levels, T = 2^17) against the plain version, through the hash field's
    entry ``hash_encode``: its values, and its dTable and dPositions."""
    from fruitnerf_tpu_torch.fields.encodings import hash_encode

    enc = dict(_hash_layouts())[name]
    layout = enc.table_layout()
    assert layout.direct[0] and not layout.direct[-1]
    g = torch.Generator(device=dev).manual_seed(len(name))
    table = torch.rand(enc.table_shape, generator=g, device=dev) * 2 - 1
    pos = (torch.rand((20000, 3), generator=g, device=dev) * 0.999 if kind == "random"
           else _points(dev, g, "ray_ordered"))
    grad = torch.randn((pos.shape[0], enc.out_dim), generator=g, device=dev)
    t_k, p_k = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
    before = dict(hg.LAUNCHES)
    out = hash_encode(t_k, p_k, enc)
    out.backward(grad)
    assert hg.LAUNCHES["corner_encode_fwd"] == before["corner_encode_fwd"] + 1
    assert hg.LAUNCHES["corner_encode_bwd"] == before["corner_encode_bwd"] + 1
    t_p, p_p = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
    ref = hg.grid_encode_corner_torch(t_p, p_p, layout, enc.features_per_level)
    ref.backward(grad)
    torch.testing.assert_close(out, ref, atol=FWD_ATOL, rtol=0)
    assert _rel(t_k.grad, t_p.grad) <= BWD_RTOL and _rel(p_k.grad, p_p.grad) <= BWD_RTOL


def _huge_layouts():
    """(name, HashEncodingConfig) of fruit_nerf_huge's parity hash grids."""
    from fruitnerf_tpu_torch.configs import fruit_nerf_huge

    m = fruit_nerf_huge(1, variant="parity").model
    return [("main", m.field.hash)] + [(f"proposal{i}", p.hash)
                                       for i, p in enumerate(m.proposal_nets)]


@pytest.mark.parametrize("kind", ["random", "ray_ordered"])
@pytest.mark.parametrize("name", ["main", "proposal0", "proposal1"])
def test_corner_kernels_at_the_huge_layouts(dev, name, kind):
    """K3/K4 at fruit_nerf_huge's parity layouts (the main field: 16
    levels, T = 2^21, res 16..8192, a 256 MiB table; each proposal field: 7
    levels, T = 2^18) against the plain version through ``hash_encode``."""
    from fruitnerf_tpu_torch.fields.encodings import hash_encode

    enc = dict(_huge_layouts())[name]
    layout = enc.table_layout()
    assert layout.direct[0] and not layout.direct[-1]
    g = torch.Generator(device=dev).manual_seed(len(name) + 1)
    table = torch.rand(enc.table_shape, generator=g, device=dev) * 2 - 1
    pos = (torch.rand((20000, 3), generator=g, device=dev) * 0.999 if kind == "random"
           else _points(dev, g, "ray_ordered"))
    grad = torch.randn((pos.shape[0], enc.out_dim), generator=g, device=dev)
    t_k, p_k = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
    hash_encode(t_k, p_k, enc).backward(grad)
    t_p, p_p = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
    ref = hg.grid_encode_corner_torch(t_p, p_p, layout, enc.features_per_level)
    ref.backward(grad)
    torch.testing.assert_close(hash_encode(table, pos, enc), ref.detach(), atol=FWD_ATOL, rtol=0)
    assert _rel(t_k.grad, t_p.grad) <= BWD_RTOL and _rel(p_k.grad, p_p.grad) <= BWD_RTOL


@pytest.mark.parametrize("name", ["proposal0", "proposal1"])
def test_corner_kernels_at_the_huge_steps_points(dev, name):
    """K3/K4 at HUGE_P = 8,388,608 ray-ordered points (a huge step's
    samples in each proposal field; 117M outputs) at its layout, against
    the plain version: no index overflows past 2^31."""
    enc = dict(_huge_layouts())[name]
    layout, f = enc.table_layout(), enc.features_per_level
    g = torch.Generator(device=dev).manual_seed(11)
    table = torch.rand(enc.table_shape, generator=g, device=dev) * 2 - 1
    pos = _points(dev, g, "ray_ordered", n_rays=HUGE_P // 512, samples=512, extra=0)
    grad = torch.randn((pos.shape[0], enc.out_dim), generator=g, device=dev)
    out = hg.corner_encode_fwd_cuda(table, pos, layout, f)
    dt, dp = hg.corner_encode_bwd_cuda(table, pos, grad, layout, f, True)
    t_p, p_p = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
    ref = hg.grid_encode_corner_torch(t_p, p_p, layout, f)
    ref.backward(grad)
    torch.testing.assert_close(out, ref.detach(), atol=FWD_ATOL, rtol=0)
    assert _rel(dt, t_p.grad) <= BWD_RTOL and _rel(dp, p_p.grad) <= BWD_RTOL


@pytest.mark.parametrize("kind", ["random", "ray_ordered"])
def test_cell_kernels_at_the_big_layout(dev, kind):
    """K1/K2 at fruit_nerf_big's grid layout (16 levels of up to 16384
    rows, res 16..4096, no two-tier cap) through ``grid_encode``, against
    the plain version."""
    from fruitnerf_tpu_torch.configs import fruit_nerf_big
    from fruitnerf_tpu_torch.fields.encodings import grid_encode

    grid = fruit_nerf_big(1).model.field.grid
    layout = grid.cell_layout()
    g = torch.Generator(device=dev).manual_seed(13)
    table = torch.rand(grid.table_shape, generator=g, device=dev) * 2 - 1
    pos = (torch.rand((20000, 3), generator=g, device=dev) * 0.999 if kind == "random"
           else _points(dev, g, "ray_ordered"))
    grad = torch.randn((pos.shape[0], 2 * layout.num_levels), generator=g, device=dev)
    t_k, p_k = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
    before = dict(hg.LAUNCHES)
    grid_encode(t_k, p_k, grid).backward(grad)
    assert hg.LAUNCHES["cell_encode_fwd"] == before["cell_encode_fwd"] + 1
    assert hg.LAUNCHES["cell_encode_bwd"] == before["cell_encode_bwd"] + 1
    t_p, p_p = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
    ref = hg.cell_encode_torch(t_p, p_p, layout)
    ref.backward(grad)
    torch.testing.assert_close(grid_encode(table, pos, grid), ref.detach(), atol=FWD_ATOL, rtol=0)
    assert _rel(t_k.grad, t_p.grad) <= BWD_RTOL and _rel(p_k.grad, p_p.grad) <= BWD_RTOL


@pytest.mark.parametrize("preset", ["fruit_nerf", "fruit_nerf_smoke"])
def test_training_repeats_under_one_seed(dev, preset):
    """Five train steps, twice, from one seed and on the same draws, on the
    kernels (K1/K2 on the cell-mode preset, K3/K4 on the smoke preset's hash
    grids): every loss and every parameter is bitwise equal. The backward
    kernels sum dTable in fixed point, and the samplers' rowwise gather
    (``core.math.take_sorted``) is an index whose CUDA backward sums in a
    sorted order, so nothing on the step depends on the order of atomics."""
    from fruitnerf_tpu_torch.configs import apply_overrides, get_preset
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
    from fruitnerf_tpu_torch.scripts.step_bench import two_runs

    scene = render_scene(SyntheticSceneConfig(image_size=64, num_cameras=8), device=dev)
    data = dataset_from_scene(scene, dev)
    cfg = get_preset(preset, data.cameras.num_cameras)
    if preset == "fruit_nerf":
        cfg = apply_overrides(cfg, {"sparsity_loss": 0.005})
    family = "cell" if preset == "fruit_nerf" else "corner"
    before = hg.LAUNCHES[f"{family}_encode_bwd"]
    r = two_runs(cfg, data, seed=0)
    assert hg.LAUNCHES[f"{family}_encode_bwd"] > before
    assert r["bitwise"], r


@pytest.fixture
def capture(dev, tmp_path):
    """A 10-camera 48^2 capture tree, written by the port's own writer."""
    from fruitnerf_tpu_torch.data.fixture import write_scene_capture
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene

    scene = render_scene(SyntheticSceneConfig(num_fruits=4, image_size=48, num_cameras=10),
                         device=dev)
    write_scene_capture(scene, tmp_path / "capture", eval_fraction=0.2)
    return tmp_path / "capture"


def test_disk_train_launches_the_cell_kernels_as_predicted(dev, capture, tmp_path):
    """``train --data <capture>`` on the grid preset at full width, a few
    steps on the card: K1/K2 twice a step (fine samples, sparsity points),
    K1 once a chunk of the final eval over the two val cameras."""
    import math

    from fruitnerf_tpu_torch.__main__ import main as port_cli
    from fruitnerf_tpu_torch.configs import fruit_nerf

    hg.reset_launch_counts()
    port_cli(["train", "--data", str(capture), "--output-dir", str(tmp_path / "run"),
              "--max-iters", "3", "--sparsity-loss", "0.005"])
    torch.cuda.synchronize()
    chunks = math.ceil(48 * 48 / fruit_nerf(10).eval_rays_per_chunk)
    assert hg.LAUNCHES["cell_encode_fwd"] == 2 * 3 + 2 * chunks
    assert hg.LAUNCHES["cell_encode_bwd"] == 2 * 3
    assert hg.LAUNCHES["corner_encode_fwd"] == hg.LAUNCHES["corner_encode_bwd"] == 0


def test_eval_and_render_run_on_the_card_by_default(dev, capture, tmp_path, capsys):
    import json

    from fruitnerf_tpu_torch.__main__ import main as port_cli
    from PIL import Image

    run = tmp_path / "run"
    port_cli(["train", "--preset", "fruit_nerf_smoke", "--data", str(capture),
              "--output-dir", str(run), "--max-iters", "2"])
    port_cli(["eval", "--load-dir", str(run), "--data", str(capture),
              "--output", str(tmp_path / "eval.json")])
    stats = json.loads((tmp_path / "eval.json").read_text())
    assert stats["device"] == "cuda" and stats["num_images_evaluated"] == 2
    capsys.readouterr()
    port_cli(["render", "--load-dir", str(run), "--data", str(capture),
              "--output-dir", str(tmp_path / "r"), "--cameras", "1"])
    assert "on cuda" in capsys.readouterr().out
    assert Image.open(tmp_path / "r" / "cam001_rgb.png").size == (48, 48)


def test_lpips_on_the_card_equals_the_cpu(dev, tmp_path):
    """At the default flags, as ``eval --lpips-weights`` runs it: ``lpips_fn``
    keeps cuDNN off TF32 and leaves the flag as it found it."""
    from fruitnerf_tpu_torch.utils.lpips import load_lpips_weights, lpips_fn

    rng = np.random.default_rng(0)

    def r(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    path = tmp_path / "lpips_tiny.npz"
    np.savez(path, shift=np.array([-0.030, -0.088, -0.188], np.float32),
             scale=np.array([0.458, 0.448, 0.450], np.float32),
             stage0_conv0_w=r(4, 3, 3, 3), stage0_conv0_b=r(4, s=0.1),
             stage0_conv1_w=r(4, 4, 3, 3), stage0_conv1_b=r(4, s=0.1),
             stage1_conv0_w=r(6, 4, 3, 3), stage1_conv0_b=r(6, s=0.1),
             lin0_w=np.abs(r(1, 4, 1, 1, s=1.0)), lin1_w=np.abs(r(1, 6, 1, 1, s=1.0)))
    w = load_lpips_weights(path)
    a = rng.random((64, 48, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    flag = torch.backends.cudnn.allow_tf32
    on_card = lpips_fn(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), w)
    assert on_card.device.type == "cuda" and torch.backends.cudnn.allow_tf32 == flag
    assert abs(float(on_card) - float(lpips_fn(a, b, w))) <= 1e-5


def _blobs(n_blobs: int, per_blob: int, noise: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    centres = rng.rand(n_blobs, 3) * 4.0
    blobs = (centres[:, None] + rng.randn(n_blobs, per_blob, 3) * 0.05).reshape(-1, 3)
    return np.concatenate([blobs, rng.rand(noise, 3) * 4.0]).astype(np.float32)


@pytest.mark.parametrize("cloud", ["random", "blobs"])
def test_dbscan_device_on_the_card_is_exact(dev, cloud):
    """The device DBSCAN engine on the card: the same noise set and core
    labels as the BFS reference and the native engine, the neighbor counts
    of a cKDTree and the native engine's outlier mask (the engine is exact:
    float32 differences summed x, y, z, no cancelling form)."""
    from scipy.spatial import cKDTree

    from fruitnerf_tpu_torch import native
    from fruitnerf_tpu_torch.counting.dbscan import dbscan_bfs
    from fruitnerf_tpu_torch.counting.dbscan_device import (
        dbscan_device,
        neighbor_counts_device,
        radius_neighbor_mask_device,
    )

    if cloud == "random":
        rng = np.random.RandomState(3)
        pts = (rng.randn(2400, 3) * 0.4 + rng.randn(3)).astype(np.float32)
        eps, ms = 0.12, 8
    else:
        pts, eps, ms = _blobs(40, 1500, 4000, 11), 0.02, 10
    labels = dbscan_device(pts, eps, ms, device=dev)
    counts_ref = cKDTree(pts).query_ball_point(pts, eps, return_length=True, workers=-1)
    core = counts_ref >= ms
    np.testing.assert_array_equal(neighbor_counts_device(pts, eps, device=dev), counts_ref)
    np.testing.assert_array_equal(radius_neighbor_mask_device(pts, eps, ms, device=dev), core)
    refs = [native.dbscan(pts, eps, ms)]
    if cloud == "random":
        refs.append(dbscan_bfs(pts, eps, ms))
    for ref in refs:
        assert ref is not None
        assert ((labels == -1) == (ref == -1)).all()
        assert (labels[core] == ref[core]).all()
    mask = native.radius_outlier_mask(pts, eps, ms)
    assert mask is not None and (mask == core).all()


# u8 levels a viewer pixel may differ between the card and the CPU: the
# kernels against the plain versions, matmuls of another library, rounded to
# 8 bits (the depth panel also through its percentile stretch)
VIEWER_U8_LEVELS = 2


@pytest.mark.parametrize("panel", ["rgb", "semantics", "depth", "accumulation"])
def test_viewer_frame_on_the_card_equals_the_cpu(dev, panel):
    """One set of smoke-preset parameters (hash tables drawn in +-0.1, so
    the frame is not flat) rendered by the viewer on the card (K3) and on
    the CPU (the plain version)."""
    from fruitnerf_tpu_torch.bridge import tree_map
    from fruitnerf_tpu_torch.configs import fruit_nerf_smoke
    from fruitnerf_tpu_torch.engine.trainer import init_train_state
    from fruitnerf_tpu_torch.viewer import ViewerSession

    config = fruit_nerf_smoke(num_images=4)
    params = init_train_state(config, 4, "cpu").params
    g = torch.Generator().manual_seed(0)
    for field in (params["model"]["field"], *params["model"]["proposal_networks"]):
        field["hash_table"] = (torch.rand(field["hash_table"].shape, generator=g) - 0.5) * 0.2
    crop = np.array([[-0.3, -0.2, -0.4], [0.4, 0.3, 0.2]])
    cpu = ViewerSession(params, config).render_frame(0.7, 0.45, 2.2, 64, panel, crop)
    before = hg.LAUNCHES["corner_encode_fwd"]
    card = ViewerSession(tree_map(params, lambda t: t.to(dev)), config).render_frame(
        0.7, 0.45, 2.2, 64, panel, crop)
    assert hg.LAUNCHES["corner_encode_fwd"] > before
    assert card.shape == cpu.shape == (64, 64, 3)
    assert int(np.abs(card.astype(int) - cpu).max()) <= VIEWER_U8_LEVELS


# ---------------------------------------------------------------------------
# the scene axis: batched launches, the multi-scene step, data parallelism
# ---------------------------------------------------------------------------


def _scene_case(dev, family: str, scenes: int = 4, n: int = 5000):
    """S tables, position sets and gradients at the fruit_nerf two-tier
    cell layout or a 16-level 2^15 corner layout (F = 2) -> (launchers,
    plain version, operands)."""
    from fruitnerf_tpu_torch.configs import fruit_nerf

    g = torch.Generator(device=dev).manual_seed(1)
    if family == "cell":
        layout = fruit_nerf(1).model.field.grid.cell_layout()
        width, out = 16, 2 * layout.num_levels
        fwd = lambda t, p: hg.cell_encode_fwd_cuda(t, p, layout)  # noqa: E731
        bwd = lambda t, p, gr: hg.cell_encode_bwd_cuda(t, p, gr, layout, True)  # noqa: E731
        plain = lambda t, p: hg.cell_encode_torch(t, p, layout)  # noqa: E731
    else:
        res = [int(16 * 1.38 ** l) for l in range(16)]
        layout = hg.corner_layout(res, 1 << 15)
        width, out = 2, 2 * layout.num_levels
        fwd = lambda t, p: hg.corner_encode_fwd_cuda(t, p, layout, 2)  # noqa: E731
        bwd = lambda t, p, gr: hg.corner_encode_bwd_cuda(t, p, gr, layout, 2, True)  # noqa: E731
        plain = lambda t, p: hg.grid_encode_corner_torch(t, p, layout, 2)  # noqa: E731
    tables = torch.rand((scenes, layout.total_rows, width), generator=g, device=dev) * 2 - 1
    pos = torch.rand((scenes, n, 3), generator=g, device=dev)
    pos[:, : n // 2] = pos[:, : n // 2].sort(dim=1).values  # ray-ordered runs, as a step's
    grad = torch.randn((scenes, n, out), generator=g, device=dev)
    return fwd, bwd, plain, tables, pos, grad


@pytest.mark.parametrize("family", ["cell", "corner"])
def test_scene_batched_kernels_equal_single_launches(dev, family):
    """K1-K4 at S = 4: one launch for the four scenes, each scene bitwise
    equal to a launch of that scene alone (forward, dTable, dPositions; the
    fixed-point scales are each scene's own), and within FWD_ATOL/BWD_RTOL
    of the plain version; a table shared by the scenes (given without the
    scene axis, as the vmap rules pass an unbatched operand) equals the
    table given to each."""
    fwd, bwd, plain, tables, pos, grad = _scene_case(dev, family)
    hg.reset_launch_counts()
    out = fwd(tables, pos)
    dt, dp = bwd(tables, pos, grad)
    name = f"{family}_encode"
    assert hg.LAUNCHES[f"{name}_fwd"] == hg.LAUNCHES[f"{name}_bwd"] == 1
    assert hg.SCENES[f"{name}_fwd"] == hg.SCENES[f"{name}_bwd"] == 4
    for s in range(4):
        assert torch.equal(out[s], fwd(tables[s], pos[s])), s
        dts, dps = bwd(tables[s], pos[s], grad[s])
        assert torch.equal(dt[s], dts) and torch.equal(dp[s], dps), s
        t_ = tables[s].clone().requires_grad_(True)
        p_ = pos[s].clone().requires_grad_(True)
        ref = plain(t_, p_)
        torch.testing.assert_close(out[s], ref.detach(), atol=FWD_ATOL, rtol=0)
        ref.backward(grad[s])
        assert _rel(dt[s], t_.grad) <= BWD_RTOL and _rel(dp[s], p_.grad) <= BWD_RTOL
    out_shared = fwd(tables[1], pos)
    dt_shared, dp_shared = bwd(tables[1], pos, grad)
    for s in range(4):
        assert torch.equal(out_shared[s], fwd(tables[1], pos[s])), s
        dts, dps = bwd(tables[1], pos[s], grad[s])
        assert torch.equal(dt_shared[s], dts) and torch.equal(dp_shared[s], dps), s
    with pytest.raises(ValueError, match="contiguous"):
        fwd(tables[1].expand(4, *tables.shape[1:]), pos)


def _tiny_smoke(num_images: int):
    import dataclasses

    from fruitnerf_tpu_torch.configs import fruit_nerf_smoke

    cfg = fruit_nerf_smoke(num_images)
    m = dataclasses.replace(cfg.model, num_nerf_samples=8, num_proposal_samples=(16, 8))
    return dataclasses.replace(cfg, model=m, train_rays_per_batch=256)


def test_multi_scene_step_on_the_card_matches_the_cpu(dev):
    """One multi-scene step of two smoke scenes on the card (K3/K4 launched
    once for both scenes at each call) against the CPU's plain versions on
    the same parameters and draws: losses within the GPU-CPU step bound."""
    from fruitnerf_tpu_torch.bridge import tree_map
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
    from fruitnerf_tpu_torch.engine.trainer import StepDraws, draw_step
    from fruitnerf_tpu_torch.parallel import multi_scene as ms

    cfg = _tiny_smoke(6)
    scenes = [render_scene(SyntheticSceneConfig(num_fruits=3, num_cameras=6, image_size=32,
                                                seed=s), device="cpu") for s in range(2)]
    cpu_state, gens = ms.init_multi_scene_state(cfg, 6, 2, "cpu")
    cpu_data = ms.stack_datasets([dataset_from_scene(s, "cpu", train_fraction=1.0)
                                  for s in scenes])
    draws = [draw_step(cfg, ms.scene_dataset(cpu_data, s), gens[s]) for s in range(2)]
    card_state, _ = ms.init_multi_scene_state(
        cfg, 6, 2, dev, params=tree_map(cpu_state.params, lambda t: t.to(dev)))
    card_data = ms.stack_datasets([dataset_from_scene(s, dev, train_fraction=1.0)
                                   for s in scenes])
    card_draws = [StepDraws(**tree_map(dict(vars(d)), lambda t: t.to(dev))) for d in draws]
    want = ms.multi_scene_step(cpu_state, cpu_data, cfg, draws=draws)
    hg.reset_launch_counts()
    got = ms.multi_scene_step(card_state, card_data, cfg, draws=card_draws)
    assert hg.SCENES["corner_encode_fwd"] == 2 * hg.LAUNCHES["corner_encode_fwd"] > 0
    assert hg.SCENES["corner_encode_bwd"] == 2 * hg.LAUNCHES["corner_encode_bwd"] > 0
    for k in ("total_loss", "rgb_loss", "semantics_loss", "interlevel_loss"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4, atol=0)


# one rank of the data-parallel test below: trains from the job's seed
# through train_loop on the card and saves its per-step metrics and params
_DP_RANK = """
import sys, torch
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.parallel import mesh as M
job_path, rank, world, init, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
job = torch.load(job_path, weights_only=False)
mesh = M.init_data_mesh("gloo", world, rank, init)
try:
    cfg, data = job["config"], job["data"]
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    metrics = []
    state = trainer.train_loop(cfg, data, generator=gen, mesh=mesh, callbacks=[
        lambda it, st, m: metrics.append({k: float(v) for k, v in m.items()})])
    torch.save({"metrics": metrics, "params": state.params}, out)
finally:
    M.close_data_mesh()
"""


def test_two_gloo_ranks_on_one_card_match_one(dev, tmp_path):
    """Two ranks sharing the card over gloo against one rank, 3 steps of
    the smoke preset from one seed: losses within 2e-5 (the JAX package's
    1-vs-N bound), the ranks bitwise equal."""
    import dataclasses
    import os
    import subprocess
    import sys
    from pathlib import Path

    from fruitnerf_tpu_torch.bridge import tree_leaves
    from fruitnerf_tpu_torch.data.builder import dataset_from_scene
    from fruitnerf_tpu_torch.data.synthetic import SyntheticSceneConfig, render_scene
    from fruitnerf_tpu_torch.engine import trainer

    cfg = dataclasses.replace(_tiny_smoke(6), max_iters=3, steps_per_eval=0, steps_per_save=0)
    data = dataset_from_scene(render_scene(SyntheticSceneConfig(num_fruits=3, num_cameras=6,
                                                                image_size=32), device="cpu"), dev)
    ref = []
    trainer.train_loop(cfg, data, generator=torch.Generator(device=dev).manual_seed(cfg.seed),
                       callbacks=[lambda it, st, m: ref.append(float(m["total_loss"]))])
    torch.save({"config": cfg, "data": data}, tmp_path / "job.pt")
    repo = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_RANK, str(tmp_path / "job.pt"), str(r), "2",
         f"file://{tmp_path / 'pg'}", str(tmp_path / f"rank{r}.pt")],
        cwd=repo, env={**os.environ, "PYTHONPATH": str(repo)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for a, b in zip(tree_leaves(ranks[0]["params"]), tree_leaves(ranks[1]["params"])):
        assert torch.equal(a, b)
    got = [m["total_loss"] for m in ranks[0]["metrics"]]
    np.testing.assert_allclose(got, ref, rtol=2e-5)
