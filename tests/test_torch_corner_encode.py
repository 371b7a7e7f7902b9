"""The port's flat grid entry (fruitnerf_tpu_torch/ops/hash_grid.py:
grid_encode_flat) against the JAX package's: corner mode (Pallas kernels
K3/K4, interpret mode on the CPU, and the ``grid_encode_ref`` oracle) and the
cell-v1 route (K5/K6 and ``grid_encode_cell_ref``), forward and gradients,
at uniform-random and ray-ordered points and F = 1, 2, 4 and 8; and the
bridge's conversions of both table layouts. Compute dtype float32 on both
sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fruitnerf_tpu.fields import encodings as jenc
from fruitnerf_tpu.ops.pallas import hash_grid as jhg
from fruitnerf_tpu_torch import bridge
from fruitnerf_tpu_torch.fields import encodings as tenc
from fruitnerf_tpu_torch.ops import hash_grid as thg

FWD_ATOL = 1e-5  # float32 sums of 8 products of O(1) values
GRAD_RTOL = 1e-4  # gradients: float32, other summation order
# elementwise: entries far below the largest take this floor, relative to it
GRAD_FLOOR = 1e-6

# (resolutions, T): level 0 direct ((7+1)^3 = 512 fills T exactly), then
# hashed levels up to res 2048, where iy*P1 and iz*P2 overflow 32 bits
RES, T = (7, 64, 1024, 2048), 512


def _corner_inputs(features, seed=0, n=400):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (len(RES), 128, features * T // 128)).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return table, pos


def _pallas(table, pos, features, mode="corner", res=RES, t=T):
    return jhg.grid_encode_flat(table, pos, res, t, features, mode, "float32", True, 1024)


def _assert_grad_close(actual, expected):
    expected = np.asarray(expected)
    np.testing.assert_allclose(
        actual, expected, rtol=GRAD_RTOL, atol=GRAD_FLOOR * np.abs(expected).max()
    )


def test_corner_layout_matches_jax():
    layout = thg.corner_layout(RES, T)
    res, direct = jhg._smem_level_arrays(RES, T, "corner")
    assert layout.resolutions == tuple(np.asarray(res).tolist())
    assert layout.direct == tuple(bool(d) for d in np.asarray(direct))
    assert layout.direct == (True, False, False, False)
    assert layout.rows == (T,) * 4 and layout.offsets == (0, T, 2 * T, 3 * T)


@pytest.mark.parametrize("features", [1, 2, 4, 8])
def test_corner_forward_matches_pallas_and_ref(features):
    table, pos = _corner_inputs(features)
    flat = torch.from_numpy(bridge.corner_table_from_jax(table, T, features))
    out = thg.grid_encode_flat(flat, torch.from_numpy(pos), RES, T, features, "corner")
    assert out.shape == (pos.shape[0], len(RES) * features)
    pallas = np.asarray(_pallas(jnp.asarray(table), jnp.asarray(pos), features))
    ref = np.asarray(jhg.grid_encode_ref(jnp.asarray(table), jnp.asarray(pos), RES, T, features))
    np.testing.assert_allclose(out.numpy(), pallas, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("features", [1, 2, 4, 8])
def test_corner_grads_match_pallas(features):
    """dTable and dPositions of sum(sin(out) * out) against jax.grad through
    K3/K4, including a point at z = 1.0 whose +z corners index past the
    direct level's table."""
    table, pos = _corner_inputs(features, seed=1, n=300)
    pos[0] = (0.5, 0.25, 1.0)

    def loss_jax(t, p):
        out = _pallas(t, p, features)
        return jnp.sum(jnp.sin(out) * out)

    dt_j, dp_j = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pos))
    flat = torch.from_numpy(bridge.corner_table_from_jax(table, T, features)).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    out = thg.grid_encode_flat(flat, p, RES, T, features, "corner")
    torch.sum(torch.sin(out) * out).backward()
    _assert_grad_close(flat.grad.numpy(), bridge.corner_table_from_jax(dt_j, T, features))
    _assert_grad_close(p.grad.numpy(), dp_j)


def _ray_ordered_positions(seed, n_rays=8, samples=48):
    """Consecutive samples along short rays, as a train step orders them:
    at the coarse levels runs of neighbours share a cell (the runs the CUDA
    backward merges). Point 3 sits at z = 1.0."""
    rng = np.random.default_rng(seed)
    origin = rng.uniform(0.2, 0.8, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    t = np.sort(rng.uniform(0.0, 1.0, (n_rays, samples, 1)), axis=1)
    pos = np.clip(origin + 0.15 * t * d / np.linalg.norm(d, axis=-1, keepdims=True), 0.0, 0.999)
    pos = pos.reshape(-1, 3).astype(np.float32)
    pos[3] = (0.5, 0.25, 1.0)
    return pos


@pytest.mark.parametrize("features", [1, 2, 4, 8])
def test_corner_ray_ordered_matches_pallas(features):
    """Forward, dTable and dPositions at ray-ordered points against the
    Pallas kernels (and the forward against ``grid_encode_ref`` away from
    the point at 1.0, where the oracle gives NaN)."""
    table, _ = _corner_inputs(features, seed=2)
    pos = _ray_ordered_positions(features)
    cells = np.floor(pos * RES[0])
    assert np.mean(np.all(cells[1:] == cells[:-1], axis=-1)) > 0.5  # runs at level 0
    flat = torch.from_numpy(bridge.corner_table_from_jax(table, T, features)).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    out = thg.grid_encode_flat(flat, p, RES, T, features, "corner")
    pallas = np.asarray(_pallas(jnp.asarray(table), jnp.asarray(pos), features))
    ref = np.asarray(jhg.grid_encode_ref(jnp.asarray(table), jnp.asarray(pos), RES, T, features))
    np.testing.assert_allclose(out.detach().numpy(), pallas, atol=FWD_ATOL, rtol=0)
    keep = np.arange(len(pos)) != 3
    np.testing.assert_allclose(out.detach().numpy()[keep], ref[keep], atol=FWD_ATOL, rtol=0)

    def loss_jax(t, q):
        o = _pallas(t, q, features)
        return jnp.sum(jnp.sin(o) * o)

    dt_j, dp_j = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pos))
    torch.sum(torch.sin(out) * out).backward()
    _assert_grad_close(flat.grad.numpy(), bridge.corner_table_from_jax(dt_j, T, features))
    _assert_grad_close(p.grad.numpy(), dp_j)


def test_corner_index_past_the_table_reads_zero():
    """At z = 1.0 the +z corners of the direct level index past its 512
    entries: the Pallas one-hot matches nothing and reads 0, while
    ``grid_encode_ref``'s take gives NaN. The port reads 0 and adds no
    gradient there; the position's gradient matches the kernel's."""
    layout = thg.corner_layout(RES, T)
    pos = np.array([[0.5, 0.25, 1.0]], np.float32)
    s = np.floor(pos[0] * RES[0]).astype(int)
    plus_z = [(s[0] + cx) + (s[1] + cy) * 8 + (s[2] + 1) * 64 for cx in (0, 1) for cy in (0, 1)]
    assert min(plus_z) >= T
    table, _ = _corner_inputs(2)
    ref = np.asarray(jhg.grid_encode_ref(jnp.asarray(table), jnp.asarray(pos), RES, T, 2))
    assert np.isnan(ref[0, :2]).all()
    flat = torch.from_numpy(bridge.corner_table_from_jax(table, T, 2)).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    out = thg.grid_encode_corner_torch(flat, p, layout, 2)
    pallas = np.asarray(_pallas(jnp.asarray(table), jnp.asarray(pos), 2))
    np.testing.assert_allclose(out.detach().numpy(), pallas, atol=FWD_ATOL, rtol=0)
    out[0, :2].sum().backward()
    # only the four -z corners take a gradient; the +z ones, clamped to row
    # T-1 for the gather, add none there
    assert int((flat.grad[:T].abs().sum(-1) > 0).sum()) == 4
    assert float(flat.grad[T - 1].abs().sum()) == 0.0
    dp_j = jax.grad(lambda q: jnp.sum(_pallas(jnp.asarray(table), q, 2)[0, :2]))(jnp.asarray(pos))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(dp_j), rtol=GRAD_RTOL, atol=1e-6)


def test_corner_hash_wraps_as_uint32():
    """Entry indices at res 2048 (hashed) equal the uint32 hash in numpy."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.0, 1.0, (300, 3)).astype(np.float32)
    ix = np.floor(pos[:, None, :] * np.float32(2048)).astype(np.int64)
    flat, valid = thg._hash_or_direct(
        torch.from_numpy(ix[..., 0]), torch.from_numpy(ix[..., 1]), torch.from_numpy(ix[..., 2]),
        2049, thg.CellLayout((2048,), (T,), (False,)))
    assert bool(valid.all())
    i = ix.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = i[..., 0] ^ (i[..., 1] * np.uint32(2654435761)) ^ (i[..., 2] * np.uint32(805459861))
    np.testing.assert_array_equal(flat.numpy(), (h & np.uint32(T - 1)).astype(np.int64))


# ---------------------------------------------------------------------------
# cell v1 (K5/K6): grid_encode_flat(mode="cell") on one uniform table
# ---------------------------------------------------------------------------

# res 8: 8^3 = 512 cells fill T (direct); res 64 and 1024 hashed
V1_RES, V1_T = (8, 64, 1024), 512


def _v1_inputs(seed=0, n=300):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (len(V1_RES), 128, 16 * V1_T // 128)).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    pos[0] = (0.5, 0.5, 1.0)  # past the direct level's cells: a zero row
    return table, pos


def test_uniform_cell_layout_matches_jax():
    layout = thg.uniform_cell_layout(V1_RES, V1_T)
    _, direct = jhg._smem_level_arrays(V1_RES, V1_T, "cell")
    assert layout.direct == tuple(bool(d) for d in np.asarray(direct)) == (True, False, False)
    assert layout.rows == (V1_T,) * 3


def test_cell_v1_forward_matches_pallas_and_ref():
    table, pos = _v1_inputs()
    flat = torch.from_numpy(bridge.cell_v1_table_from_jax(table))
    out = thg.grid_encode_flat(flat, torch.from_numpy(pos), V1_RES, V1_T, 2, "cell")
    pallas = np.asarray(_pallas(jnp.asarray(table), jnp.asarray(pos), 2, "cell", V1_RES, V1_T))
    ref = np.asarray(jhg.grid_encode_cell_ref(jnp.asarray(table), jnp.asarray(pos),
                                              V1_RES, V1_T, 2))
    np.testing.assert_array_equal(out[0, :2].numpy(), 0.0)
    np.testing.assert_allclose(out.numpy(), pallas, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy()[1:], ref[1:], atol=FWD_ATOL, rtol=0)


def test_cell_v1_grads_match_pallas():
    table, pos = _v1_inputs(seed=1)

    def loss_jax(t, p):
        out = _pallas(t, p, 2, "cell", V1_RES, V1_T)
        return jnp.sum(jnp.sin(out) * out)

    dt_j, dp_j = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pos))
    flat = torch.from_numpy(bridge.cell_v1_table_from_jax(table)).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    out = thg.grid_encode_flat(flat, p, V1_RES, V1_T, 2, "cell")
    torch.sum(torch.sin(out) * out).backward()
    _assert_grad_close(flat.grad.numpy(), bridge.cell_v1_table_from_jax(dt_j))
    _assert_grad_close(p.grad.numpy(), dp_j)


# ---------------------------------------------------------------------------
# bridge and wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("features", [2, 4])
def test_corner_table_bridge_is_the_f_major_transpose(features):
    table, _ = _corner_inputs(features)
    flat = bridge.corner_table_from_jax(table, T, features)
    lo = T // 128
    l, t, f = 2, 5 * lo + 3, features - 1  # entry t = hi*LO + lo at [l, hi, f*LO + lo]
    assert flat[l * T + t, f] == table[l, 5, f * lo + 3]
    np.testing.assert_array_equal(bridge.corner_table_to_jax(flat, T, features), table)
    with pytest.raises(ValueError, match="layout wants"):
        bridge.corner_table_from_jax(table[:, :64], T, features)


def test_cell_v1_table_bridge_is_a_reshape():
    table, _ = _v1_inputs()
    flat = bridge.cell_v1_table_from_jax(table)
    clo = V1_T // 128
    # cell t = hi*CLO + lo at [l, hi, lo*16 + j]
    assert flat[1 * V1_T + 7 * clo + 2, 9] == table[1, 7, 2 * 16 + 9]
    np.testing.assert_array_equal(bridge.cell_v1_table_to_jax(flat, V1_T), table)


def test_corner_grid_config_matches_jax():
    kw = dict(num_levels=4, table_size=512, base_res=4, max_res=64, mode="corner",
              features_per_level=4)
    jcfg, tcfg = jenc.GridEncodingConfig(**kw), tenc.GridEncodingConfig(**kw)
    assert tcfg.out_dim == jcfg.out_dim == 16
    assert tcfg.level_resolutions() == jcfg.level_resolutions()
    assert tcfg.table_shape == (4 * 512, 4)
    jt = jenc.init_grid_table(jax.random.PRNGKey(0), jcfg)
    assert bridge.corner_table_from_jax(jt, 512, 4).shape == tcfg.table_shape
    tt = tenc.init_grid_table(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert tt.shape == tcfg.table_shape and float(tt.abs().max()) <= 1e-4
    # JAX's validations
    with pytest.raises(ValueError, match="two-tier"):
        tenc.GridEncodingConfig(mode="corner", mid_table_size=4096)
    with pytest.raises(ValueError, match="features_per_level must be 2"):
        tenc.GridEncodingConfig(mode="cell", features_per_level=4)
    with pytest.raises(ValueError, match="mode"):
        tenc.GridEncodingConfig(mode="hash")


def test_corner_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: no fallback to the plain version."""
    layout = thg.corner_layout(RES, T)
    table = torch.zeros((layout.total_rows, 2))
    pos = torch.full((4, 3), 0.5)
    before = dict(thg.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        thg.corner_encode_fwd_cuda(table, pos, layout, 2)
    with pytest.raises(ValueError, match="expected a tensor on"):
        thg.corner_encode_bwd_cuda(table, pos, torch.zeros((4, 8)), layout, 2, True)
    with pytest.raises(ValueError, match="features"):
        thg.corner_encode_fwd_cuda(table, pos, layout, 9)
    thg.grid_encode_flat(table, pos, RES, T, 2, "corner")  # the CPU path counts no launch
    assert thg.LAUNCHES == before
    with pytest.raises(ValueError, match="table on"):
        thg.grid_encode_flat(table, pos.to("meta"), RES, T, 2, "corner")
    with pytest.raises(ValueError, match="mode"):
        thg.grid_encode_flat(table, pos, RES, T, 2, "hash")
