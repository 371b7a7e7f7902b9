"""The CUDA kernels (cell_encode, corner_encode, and the cell-v1 route of
grid_encode_flat) against their plain PyTorch versions, on a card. Every test here is marked ``gpu`` and skips without one. This file
imports no JAX, so it runs on the GPU machine, which has none:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)"""
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
