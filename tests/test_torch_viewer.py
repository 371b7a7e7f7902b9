"""The port's viewer (``viewer/server.py``) on the CPU: the HTTP round
trips of tests/test_viewer.py against a live server on an ephemeral port
(the UI page, /info, each panel, preview frames, the crop overlay,
/suggest); frames against the JAX package's ``ViewerSession`` on the smoke
preset's parameters made by JAX and bridged into the port; the crop-box
overlay against the JAX function's; and a frame served from a handler
thread, which renders in inference mode and builds no autograd graph.
``viewer --mesh``: tests/test_torch_mesh_inference.py."""
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from fruitnerf_tpu.viewer import ViewerSession as JaxViewerSession
from fruitnerf_tpu.viewer.server import draw_crop_box as jax_draw_crop_box
from fruitnerf_tpu.viewer.server import orbit_camera as jax_orbit_camera
from fruitnerf_tpu_torch.configs import fruit_nerf_smoke
from fruitnerf_tpu_torch.engine import trainer
from fruitnerf_tpu_torch.engine.trainer import init_train_state
from fruitnerf_tpu_torch.viewer import ViewerSession, serve
from fruitnerf_tpu_torch.viewer.server import draw_crop_box, orbit_camera
from test_torch_rgb_pointcloud import bridged_smoke

TIMEOUT_S = 60  # a request's time limit
# u8 levels a frame's pixel may differ from the JAX package's: float32
# renders of one set of parameters by two libraries, rounded to 8 bits
# (the depth panel also through its 2-98 percentile stretch)
U8_LEVELS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: with six test workers on the
    host, torch's thread pools would oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def session():
    config = fruit_nerf_smoke(num_images=4)
    state = init_train_state(config, 4, "cpu")
    return ViewerSession(state.params, config)


@pytest.fixture(scope="module")
def base_url(session):
    httpd = serve(session, port=0)  # ephemeral port
    host, port = httpd.server_address
    yield f"http://{host}:{port}"
    httpd.shutdown()
    httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _png(body) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)))


def test_index_page(base_url):
    status, ctype, body = _get(base_url + "/")
    assert status == 200 and ctype == "text/html"
    assert b"/render?" in body and b"bounding-box-min" in body


def test_info(base_url, session):
    status, _, body = _get(base_url + "/info")
    info = json.loads(body)
    assert status == 200 and info["preset"] == session.config.preset == "fruit_nerf_smoke"
    assert info["panels"] == ["rgb", "semantics", "depth", "accumulation"]
    assert np.asarray(info["scene_aabb"]).shape == (2, 3)


@pytest.mark.parametrize("panel", ["rgb", "semantics", "depth", "accumulation"])
def test_render_panels(base_url, panel):
    status, ctype, body = _get(
        base_url + f"/render?theta=0.5&phi=0.4&radius=2.5&size=32&panel={panel}")
    assert status == 200 and ctype == "image/png"
    img = _png(body)
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8


def test_render_preview_mode(base_url, session):
    """preview=1 renders through the reduced-sample config (the interactive
    orbit path) and still returns a well-formed frame."""
    preview, full = session.preview_config.model, session.config.model
    assert preview.num_nerf_samples == max(full.num_nerf_samples // 3, 8) < full.num_nerf_samples
    assert preview.num_proposal_samples == tuple(max(n // 4, 16)
                                                 for n in full.num_proposal_samples)
    status, ctype, body = _get(
        base_url + "/render?theta=0.5&phi=0.4&radius=2.5&size=32&panel=rgb&preview=1")
    assert status == 200 and ctype == "image/png"
    img = _png(body)
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8


def test_render_with_crop_overlay(base_url):
    q = "theta=0.5&phi=0.4&radius=2.5&size=48&panel=rgb"
    a = _png(_get(base_url + f"/render?{q}")[2])
    b = _png(_get(base_url + f"/render?{q}&crop=-0.5,-0.5,-0.5,0.5,0.5,0.5")[2])
    assert (a != b).any()  # overlay drew something
    assert (b == np.array([255, 220, 40])).all(-1).any()  # in the overlay colour


def test_suggest_crop_endpoint(base_url):
    status, _, body = _get(base_url + "/suggest")
    out = json.loads(body)
    assert status == 200 and "aabb" in out
    if out["aabb"] is not None:
        aabb = np.asarray(out["aabb"])
        assert aabb.shape == (2, 3) and (aabb[0] <= aabb[1]).all()


def test_unknown_path_and_a_bad_query(base_url):
    with pytest.raises(urllib.error.HTTPError, match="404"):
        _get(base_url + "/nothing")
    with pytest.raises(urllib.error.HTTPError, match="500"):
        _get(base_url + "/render?crop=1,2")


def test_a_handler_thread_renders_in_inference_mode(base_url, monkeypatch):
    """Grad mode is per thread: the frame a handler thread serves is
    rendered in inference mode, and no output of the model carries an
    autograd graph, although the parameters require gradients."""
    seen = []
    real = trainer.forward_train

    def spy(params, *a, **k):
        out = real(params, *a, **k)
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.is_inference_mode_enabled(), torch.is_grad_enabled(),
                     params["field"]["base_mlp"]["w0"].requires_grad,
                     any(isinstance(v, torch.Tensor) and v.requires_grad for v in out.values())))
        return out

    monkeypatch.setattr(trainer, "forward_train", spy)
    status, _, _ = _get(base_url + "/render?theta=0.1&phi=0.3&radius=2.5&size=16&panel=depth")
    assert status == 200 and seen
    assert all(s == (False, True, False, True, False) for s in seen), seen


@pytest.fixture(scope="module")
def sessions():
    jcfg, jparams, tcfg, tparams = bridged_smoke(4, seed=2)
    return JaxViewerSession(jparams, jcfg), ViewerSession(tparams, tcfg)


@pytest.mark.parametrize("preview", [False, True], ids=["full", "preview"])
@pytest.mark.parametrize("panel", ["rgb", "semantics", "depth", "accumulation"])
def test_render_frame_matches_jax(sessions, panel, preview):
    jax_session, session = sessions
    crop = np.array([[-0.3, -0.2, -0.4], [0.4, 0.3, 0.2]])
    got = session.render_frame(0.7, 0.45, 2.2, 40, panel, crop, preview=preview)
    want = jax_session.render_frame(0.7, 0.45, 2.2, 40, panel, crop, preview=preview)
    assert got.shape == want.shape == (40, 40, 3) and got.dtype == want.dtype == np.uint8
    assert int(np.abs(got.astype(int) - want).max()) <= U8_LEVELS
    assert len(np.unique(want)) > 2  # the panel is not flat


@pytest.mark.parametrize("theta, phi, crop", [
    (0.3, 0.5, [[-0.4] * 3, [0.4] * 3]),
    (2.1, 1.2, [[-0.9, -0.1, -0.3], [0.2, 0.8, 0.6]]),
    (0.3, 0.5, [[4.0] * 3, [5.0] * 3]),  # behind the camera: nothing drawn
    (-1.0, 0.1, [[-3.0] * 3, [3.0] * 3]),  # edges cross the image border
])
def test_draw_crop_box_matches_jax(theta, phi, crop):
    img = np.random.RandomState(0).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    crop = np.asarray(crop)
    got = draw_crop_box(img, orbit_camera(theta, phi, 2.5, 64), crop)
    want = jax_draw_crop_box(img, jax_orbit_camera(theta, phi, 2.5, 64), crop)
    np.testing.assert_array_equal(got, want)
    if crop[0, 0] == 4.0:
        assert (got == img).all()
    else:
        assert (got != img).any()


def test_orbit_camera_matches_jax():
    got = orbit_camera(0.9, 0.35, 1.7, 50, target=(0.1, -0.2, 0.3), fov_deg=45.0)
    want = jax_orbit_camera(0.9, 0.35, 1.7, 50, target=(0.1, -0.2, 0.3), fov_deg=45.0)
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "distortion"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-7, err_msg=name)
