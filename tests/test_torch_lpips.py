"""The port's LPIPS (``fruitnerf_tpu_torch/utils/lpips.py``) against the JAX
package's on a tiny synthetic weights ``.npz`` (no pretrained weights exist
here), and tests/test_lpips.py mirrored: schema loading, an independent
torch formula, metric properties, batched NCHW input, the errors. Inputs
come from numpy seeds; float32 on both sides."""
import numpy as np
import pytest
import torch
from test_lpips import _tiny_npz, _torch_lpips

from fruitnerf_tpu.utils import lpips as jax_lpips
from fruitnerf_tpu_torch.utils.lpips import load_lpips_weights, lpips, lpips_fn

JAX_ATOL = 1e-5  # float32 convolutions in two libraries; observed <= 1e-7


@pytest.mark.parametrize("shape", [(16, 16, 3), (13, 21, 3), (2, 3, 8, 8)],
                         ids=["hwc", "odd_hwc", "nchw"])
def test_lpips_equals_jax(tmp_path, shape):
    path, _ = _tiny_npz(tmp_path)
    rng = np.random.RandomState(7)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*shape), 0, 1).astype(np.float32)
    got = float(lpips_fn(a, b, load_lpips_weights(path)))
    want = float(jax_lpips.lpips_fn(a, b, jax_lpips.load_lpips_weights(path)))
    assert abs(got - want) <= JAX_ATOL, (got, want)
    assert lpips(a, b, weights_path=path) == pytest.approx(got, abs=0)


def test_weights_load_like_jax(tmp_path):
    path, _ = _tiny_npz(tmp_path)
    got, want = load_lpips_weights(path), jax_lpips.load_lpips_weights(path)
    assert [len(s) for s in got["stages"]] == [len(s) for s in want["stages"]] == [2, 1]
    for gs, ws in zip(got["stages"], want["stages"]):
        for (gw, gb), (ww, wb) in zip(gs, ws):
            np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
            np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    for k in ("shift", "scale"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for g, w in zip(got["lins"], want["lins"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lpips_matches_torch_reference(tmp_path):
    path, raw = _tiny_npz(tmp_path)
    rng = np.random.RandomState(1)
    a = rng.rand(16, 16, 3).astype(np.float32)
    b = rng.rand(16, 16, 3).astype(np.float32)
    np.testing.assert_allclose(lpips(a, b, weights_path=path), _torch_lpips(a, b, raw), rtol=1e-4)


def test_lpips_metric_properties(tmp_path):
    path, _ = _tiny_npz(tmp_path)
    rng = np.random.RandomState(2)
    a = rng.rand(12, 12, 3).astype(np.float32)
    b = rng.rand(12, 12, 3).astype(np.float32)
    assert lpips(a, a, weights_path=path) == pytest.approx(0.0, abs=1e-6)
    dab = lpips(a, b, weights_path=path)
    assert dab > 0
    assert lpips(b, a, weights_path=path) == pytest.approx(dab, rel=1e-5)


def test_lpips_on_tensors_stays_on_their_device(tmp_path):
    """Tensor inputs (as ``evaluate_image`` passes them) give the array
    result; the weights follow the inputs' device."""
    path, _ = _tiny_npz(tmp_path)
    rng = np.random.RandomState(3)
    a = rng.rand(2, 3, 8, 8).astype(np.float32)
    b = rng.rand(2, 3, 8, 8).astype(np.float32)
    w = load_lpips_weights(path)
    val = lpips_fn(torch.from_numpy(a), torch.from_numpy(b), w)
    assert val.device.type == "cpu" and val.dtype == torch.float32
    assert np.isfinite(float(val)) and float(val) > 0
    assert float(val) == float(lpips_fn(a, b, w))


def test_lpips_without_weights_raises():
    with pytest.raises(NotImplementedError, match="weights"):
        lpips(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)))


def test_lpips_bad_npz_schema(tmp_path):
    path = tmp_path / "bad.npz"
    np.savez(path, foo=np.zeros(3))
    with pytest.raises(ValueError, match="schema"):
        load_lpips_weights(path)
