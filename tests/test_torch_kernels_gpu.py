"""The CUDA kernels (cell_encode, corner_encode, and the cell-v1 route of
grid_encode_flat) against their plain PyTorch versions, on a card: the
tiled kernels also at ray-ordered points, with every point in one cell
(and the corner kernels at hash collisions inside a warp and at F = 1 to
8), at 1 to 32 levels and at a P that is no multiple of their tile. Every
test here is marked ``gpu`` and skips without one. This file
imports no JAX, so it runs on the GPU machine, which has none:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)"""
import numpy as np
import pytest
import torch

from fruitnerf_tpu_torch.fields.encodings import GridEncodingConfig
from fruitnerf_tpu_torch.ops import hash_grid as hg

FWD_ATOL = 1e-5  # float32 sums of 8 products of O(1) values
BWD_RTOL = 1e-4  # relative to each gradient's max; atomics reorder the sums

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
    row merged into float4 atomics) against the plain version, with and
    without dPositions."""
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
    assert none is None and _rel(dt_only, t_.grad) <= BWD_RTOL


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
    cell merged into vector atomics) against the plain version, with and
    without dPositions."""
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
    assert none is None and _rel(dt_only, t_.grad) <= BWD_RTOL


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
