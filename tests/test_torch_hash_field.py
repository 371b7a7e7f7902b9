"""The port's hash-grid field (fruitnerf_tpu_torch/fields/encodings.py
``hash_encode``, fields/density_field.py, the ``encoding="hash"`` FruitField)
against the JAX package's on the same inputs and parameters: the configs'
derived properties; ``hash_encode`` in corner mode (the JAX package's XLA
gathers against the port's corner path, K3/K4's plain version here) and in
cell mode (``_hash_encode_cell_wide`` against the cell path at
``uniform_cell_layout``), forward and gradients; the cell-mode checks of
tests/test_hash_modes.py; the proposal DensityField with the contraction and
with an AABB. Inputs come from a numpy seed; float32 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fruitnerf_tpu.fields import density_field as jdf
from fruitnerf_tpu.fields import encodings as jenc
from fruitnerf_tpu.fields import fruit_field as jff
from fruitnerf_tpu_torch import bridge
from fruitnerf_tpu_torch.fields import density_field as tdf
from fruitnerf_tpu_torch.fields import encodings as tenc
from fruitnerf_tpu_torch.fields import fruit_field as tff
from fruitnerf_tpu_torch.models.fruit_model import FruitModelConfig

FWD_ATOL = 1e-6  # float32 sums of 8 products of O(1) values; observed <= 5e-7
GRAD_RTOL = 1e-5  # gradients, relative to each one's max magnitude
FIELD_ATOL = 1e-5  # float32 MLP outputs of O(1)

# (levels, log2 T, base res, max res): the smoke preset's main field and its
# first proposal field, and the parity variant's main field (16 levels,
# 2^19 entries)
LAYOUTS = {
    "smoke_main": (8, 13, 4, 128),
    "smoke_proposal": (4, 11, 4, 64),
    "parity_main": (16, 19, 16, 2048),
}


def _configs(levels, log2_t, base, top, mode="corner"):
    kw = dict(num_levels=levels, log2_hashmap_size=log2_t, base_res=base, max_res=top, mode=mode)
    return jenc.HashEncodingConfig(**kw), tenc.HashEncodingConfig(**kw)


def _table(jcfg, seed):
    """An O(1) table in the JAX layout [L, T, row_width], so each corner's
    term is visible."""
    return np.asarray(jenc.init_hash_table(jax.random.PRNGKey(seed), jcfg)) * 1e4


def _grad_close(actual, expected, rtol=GRAD_RTOL):
    expected = np.asarray(expected)
    err = np.abs(np.asarray(actual) - expected).max()
    assert err <= rtol * max(np.abs(expected).max(), 1e-30), err


@pytest.mark.parametrize("layout", [*LAYOUTS.values(), (4, 10, 4, 64)],
                         ids=[*LAYOUTS, "cell_sized"])
@pytest.mark.parametrize("mode", ["corner", "cell"])
def test_hash_config_properties_match_jax(layout, mode):
    jcfg, tcfg = _configs(*layout, mode=mode)
    for name in ("table_size", "row_width", "out_dim", "growth_factor"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.level_resolutions() == jcfg.level_resolutions()
    assert tcfg.table_shape == (jcfg.num_levels * jcfg.table_size, jcfg.row_width)
    rows = tcfg.table_layout()
    direct = [((r + 1) ** 3 if mode == "corner" else r**3) <= jcfg.table_size
              for r in jcfg.level_resolutions()]
    assert list(rows.direct) == direct and set(rows.rows) == {jcfg.table_size}


def _encode_both(jcfg, tcfg, table, pos, probe):
    """-> ((JAX out, dTable, dPos), (port out, dTable, dPos)); the gradients
    are those of sum(out * probe), the port's dTable in the JAX layout."""
    def loss(t, p):
        out = jenc.hash_encode(t, p, jcfg)
        return jnp.sum(out * probe), out

    (_, jout), (jdt, jdp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(table), jnp.asarray(pos))
    t = torch.from_numpy(bridge.hash_table_from_jax(table, tcfg)).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    tout = tenc.hash_encode(t, p, tcfg)
    (tout * torch.from_numpy(probe)).sum().backward()
    tdt = bridge.hash_table_to_jax(t.grad.numpy(), tcfg)
    return (jout, jdt, jdp), (tout.detach().numpy(), tdt, p.grad.numpy())


@pytest.mark.parametrize("layout", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_hash_encode_corner_matches_jax(layout):
    """Corner mode at the smoke preset's two layouts and the parity
    variant's: values, dTable and dPositions against ``jax.grad`` of the JAX
    package's ``hash_encode``. Points in [0, 1), where every corner lies in
    its level's table."""
    jcfg, tcfg = _configs(*layout)
    rng = np.random.default_rng(sum(layout))
    table = _table(jcfg, 0)
    pos = rng.uniform(0.0, 0.999, (300, 3)).astype(np.float32)
    probe = rng.normal(size=(300, jcfg.out_dim)).astype(np.float32)
    (jout, jdt, jdp), (tout, tdt, tdp) = _encode_both(jcfg, tcfg, table, pos, probe)
    np.testing.assert_allclose(tout, np.asarray(jout), atol=FWD_ATOL, rtol=0)
    _grad_close(tdt, jdt)
    _grad_close(tdp, jdp)


def test_hash_encode_cell_matches_jax():
    """Cell mode (one 16-float row a cell, direct where res^3 <= T) against
    the JAX package's wide formulation ``_hash_encode_cell_wide``."""
    jcfg, tcfg = _configs(5, 10, 4, 64, mode="cell")
    assert tcfg.table_layout().direct == (True, True, False, False, False)
    rng = np.random.default_rng(7)
    table = _table(jcfg, 1)
    pos = rng.uniform(0.0, 0.999, (300, 3)).astype(np.float32)
    probe = rng.normal(size=(300, jcfg.out_dim)).astype(np.float32)
    (jout, jdt, jdp), (tout, tdt, tdp) = _encode_both(jcfg, tcfg, table, pos, probe)
    np.testing.assert_allclose(tout, np.asarray(jout), atol=FWD_ATOL, rtol=0)
    _grad_close(tdt, jdt)
    _grad_close(tdp, jdp)


def test_cell_mode_needs_two_features():
    with pytest.raises(ValueError, match="features_per_level must be 2"):
        tenc.HashEncodingConfig(features_per_level=4, mode="cell")
    with pytest.raises(ValueError, match="mode"):
        tenc.HashEncodingConfig(mode="wide")


# tests/test_hash_modes.py:25-60, on the port


def test_cell_mode_shapes_and_rowwidth():
    cfg = tenc.HashEncodingConfig(num_levels=4, log2_hashmap_size=10, base_res=4, max_res=32,
                                  mode="cell")
    assert cfg.row_width == 16
    table = tenc.init_hash_table(cfg, torch.Generator().manual_seed(0), "cpu")
    assert table.shape == (4 * 1024, 16)
    assert float(table.abs().max()) <= 1e-4
    out = tenc.hash_encode(table, torch.rand((9, 3), generator=torch.Generator().manual_seed(1)),
                           cfg)
    assert out.shape == (9, 8)


def test_cell_mode_smooth_inside_cell_exact_at_corner_weighting():
    cfg = tenc.HashEncodingConfig(num_levels=1, log2_hashmap_size=12, base_res=4, max_res=4,
                                  mode="cell")
    table = tenc.init_hash_table(cfg, torch.Generator().manual_seed(0), "cpu")
    # a point at its cell's 0-corner reads that corner's slot
    x = torch.tensor([[0.25, 0.5, 0.75]])  # cell (1, 2, 3) on the res-4 grid
    out = tenc.hash_encode(table, x, cfg)
    cell_idx = 1 + 2 * 4 + 3 * 16  # direct indexing, stride res = 4
    np.testing.assert_allclose(out[0].numpy(), table[cell_idx, 0:2].numpy(), atol=1e-6)
    d = tenc.hash_encode(table, x + 1e-5, cfg) - out  # continuous inside the cell
    assert float(d.abs().max()) < 1e-5


def test_cell_mode_gradients():
    cfg = tenc.HashEncodingConfig(num_levels=2, log2_hashmap_size=8, base_res=4, max_res=16,
                                  mode="cell")
    table = tenc.init_hash_table(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    x = torch.rand((5, 3), generator=torch.Generator().manual_seed(1))
    (tenc.hash_encode(table, x, cfg) ** 2).sum().backward()
    assert float(table.grad.abs().sum()) > 0


@pytest.mark.parametrize("aabb", [None, [[-1.5, -1.0, -1.2], [1.0, 1.5, 1.3]]],
                         ids=["contraction", "aabb"])
def test_density_field_matches_jax(aabb):
    """The proposal DensityField (the smoke preset's second): density and
    the gradients of its table and MLP."""
    kw = dict(num_levels=4, log2_hashmap_size=11, base_res=4, max_res=128)
    jcfg = jdf.DensityFieldConfig(hash=jenc.HashEncodingConfig(**kw))
    tcfg = tdf.DensityFieldConfig(hash=tenc.HashEncodingConfig(**kw))
    jparams = jax.tree.map(np.asarray, jdf.init_density_field(jax.random.PRNGKey(3), jcfg))
    jparams["hash_table"] = jparams["hash_table"] * 1e4
    rng = np.random.default_rng(4)
    pos = rng.normal(0, 1.2, (7, 9, 3)).astype(np.float32)
    probe = rng.normal(size=(7, 9)).astype(np.float32)
    box = None if aabb is None else np.asarray(aabb, np.float32)

    def jloss(p):
        d = jdf.density_field_forward(p, jnp.asarray(pos), jcfg, contraction=box is None,
                                      aabb=None if box is None else jnp.asarray(box))
        return jnp.sum(d * probe), d

    (_, jd), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = {"hash_table": torch.from_numpy(bridge.hash_table_from_jax(
                   jparams["hash_table"], tcfg.hash)).requires_grad_(True),
               "mlp": {k: torch.tensor(v).requires_grad_(True)
                       for k, v in jparams["mlp"].items()}}
    td = tdf.density_field_forward(tparams, torch.from_numpy(pos), tcfg,
                                   contraction=box is None,
                                   aabb=None if box is None else torch.from_numpy(box))
    (td * torch.from_numpy(probe)).sum().backward()
    if box is not None:  # the AABB's selector zeroes the points outside it
        assert bool((td == 0).any()) and bool((td > 0).any())
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), atol=FIELD_ATOL, rtol=1e-4)
    _grad_close(bridge.hash_table_to_jax(tparams["hash_table"].grad.numpy(), tcfg.hash),
                jg["hash_table"], rtol=1e-4)
    for k, v in tparams["mlp"].items():
        _grad_close(v.grad.numpy(), jg["mlp"][k], rtol=1e-4)


def test_hash_fruit_field_matches_jax():
    """The FruitField with ``encoding="hash"`` (the smoke preset's widths):
    density, rgb and semantics, and the hash table's gradient."""
    kw = dict(num_images=4, hidden_dim=32, geo_feat_dim=15, hidden_dim_color=32,
              hidden_dim_semantic=32, appearance_embed_dim=8, density_bias=-1.0)
    hkw = dict(num_levels=8, log2_hashmap_size=13, base_res=4, max_res=128)
    jcfg = jff.FruitFieldConfig(hash=jenc.HashEncodingConfig(**hkw), encoding="hash",
                                compute_dtype=jnp.float32, **kw)
    tcfg = tff.FruitFieldConfig(hash=tenc.HashEncodingConfig(**hkw), encoding="hash",
                                compute_dtype=torch.float32, **kw)
    assert tcfg.base_mlp.in_dim == jcfg.base_mlp.in_dim == 16
    jparams = jax.tree.map(np.asarray, jff.init_fruit_field(jax.random.PRNGKey(5), jcfg))
    jparams["hash_table"] = jparams["hash_table"] * 1e4
    rng = np.random.default_rng(6)
    pos = rng.normal(0, 0.8, (6, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ci = rng.integers(0, 4, 6)
    probe = {k: rng.normal(size=s).astype(np.float32)
             for k, s in (("density", (6, 8)), ("rgb", (6, 8, 3)), ("semantics", (6, 8, 1)))}

    def jloss(p):
        out = jff.fruit_field_forward(p, jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(ci),
                                      jcfg, train=True)
        return sum(jnp.sum(out[k] * probe[k]) for k in probe), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = bridge.params_from_jax(
        {"model": {"field": jparams, "proposal_networks": []}, "camera_opt": np.zeros((1, 6))},
        FruitModelConfig(field=tcfg, proposal_nets=()), "cpu")["model"]["field"]
    tparams = bridge.tree_map(tparams, lambda t: t.requires_grad_(True))
    assert set(tparams) == set(jparams) and tparams["hash_table"].shape == (8 * 8192, 2)
    tout = tff.fruit_field_forward(tparams, torch.from_numpy(pos), torch.from_numpy(dirs),
                                   torch.from_numpy(ci), tcfg, train=True)
    sum(torch.sum(tout[k] * torch.from_numpy(probe[k])) for k in probe).backward()
    for k in probe:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                   atol=FIELD_ATOL, rtol=1e-4, err_msg=k)
    _grad_close(bridge.hash_table_to_jax(tparams["hash_table"].grad.numpy(), tcfg.hash),
                jg["hash_table"], rtol=1e-4)
    _grad_close(tparams["base_mlp"]["w0"].grad.numpy(), jg["base_mlp"]["w0"], rtol=1e-4)


def test_freq_encoding_is_not_ported():
    """The freq encoding is ported now (tests/test_torch_freq_field.py): it
    builds with no table; an encoding the JAX package lacks raises."""
    cfg = tff.FruitFieldConfig(num_images=1, encoding="freq")
    assert cfg.table_key is None and cfg.encoding_config is None
    with pytest.raises(ValueError, match="encoding"):
        tff.FruitFieldConfig(num_images=1, encoding="octree")
