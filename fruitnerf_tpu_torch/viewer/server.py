"""Interactive HTTP viewer: orbit a trained field, pick export crop boxes.
Twin of ``fruitnerf_tpu/viewer/server.py``.

The reference serves nerfstudio's websocket viewer for this (debug/viewer.py:
86-112, ViewerConfig num_rays_per_chunk 1<<13 fruit_nerf_config.py:57-58); its
documented role in the pipeline is *crop-box discovery* — orbit the scene,
shrink a box around the tree, copy the bounds into `ns-export-semantics
--bounding-box-min/max` (README.md:216). This module rebuilds that workflow
dependency-free: a stdlib ThreadingHTTPServer renders panels on demand
through the chunked render path eval uses (engine/trainer.render_camera),
overlays the crop box, and emits the exact `export` command line for the
chosen bounds. A "suggest" action runs the occupancy probe from
scripts/suggest_crop.py.

    python -m fruitnerf_tpu_torch viewer --load-dir runs/demo --port 7007

Endpoints: GET / (UI), /render?theta=&phi=&radius=&size=&panel=&crop=...
(PNG), /suggest (occupancy-probed AABB as JSON), /info.

Requests are served on handler threads, one render at a time on the
device; each render enters ``torch.inference_mode`` itself, because grad
mode is per thread. It runs on the card unless ``--device cpu`` asks for
the CPU; ``--mesh`` splits each frame's rays over every visible card.
"""
from __future__ import annotations

import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PANELS = ("rgb", "semantics", "depth", "accumulation")


def orbit_camera(theta: float, phi: float, radius: float, size: int,
                 target=(0.0, 0.0, 0.0), fov_deg: float = 60.0, device="cpu"):
    """Single-camera ``Cameras`` on an orbit around ``target``, on ``device``.

    theta: azimuth rad; phi: elevation rad (0 = horizon, pi/2 = top-down).
    """
    from ..cameras.cameras import Cameras
    from ..data.synthetic import look_at_pose

    target = np.asarray(target, np.float64)
    eye = target + radius * np.array([
        np.cos(theta) * np.cos(phi),
        np.sin(theta) * np.cos(phi),
        np.sin(phi),
    ])
    c2w = look_at_pose(eye, target)[None]
    f = 0.5 * size / np.tan(0.5 * np.deg2rad(fov_deg))

    def one(v, dtype=torch.float32):
        return torch.full((1,), v, dtype=dtype, device=device)

    return Cameras(
        camera_to_worlds=torch.as_tensor(c2w, device=device),
        fx=one(f), fy=one(f),
        cx=one(0.5 * size), cy=one(0.5 * size),
        width=one(size, torch.int64),
        height=one(size, torch.int64),
        distortion=torch.zeros((1, 6), device=device),
    )


def _project(c2w: np.ndarray, f: float, size: int, pts: np.ndarray):
    """World points -> pixel coords (+in-front mask), OpenGL camera."""
    R, t = c2w[:, :3], c2w[:, 3]
    cam = (pts - t) @ R  # world -> camera (R columns orthonormal)
    in_front = cam[:, 2] < -1e-6
    z = np.where(in_front, cam[:, 2], -1.0)
    x = 0.5 * size + f * cam[:, 0] / -z
    y = 0.5 * size - f * cam[:, 1] / -z
    return np.stack([x, y], -1), in_front


_BOX_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_crop_box(img: np.ndarray, cameras, crop: np.ndarray,
                  fov_deg: float = 60.0,
                  color=(255, 220, 40)) -> np.ndarray:
    """Overlay the crop AABB's 12 edges onto a rendered [H,W,3] uint8 image."""
    size = img.shape[0]
    f = 0.5 * size / np.tan(0.5 * np.deg2rad(fov_deg))
    lo, hi = crop
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]])
    c2w = cameras.camera_to_worlds[0].cpu().numpy()
    px, ok = _project(c2w, f, size, corners)
    out = img.copy()
    for a, b in _BOX_EDGES:
        if not (ok[a] and ok[b]):
            continue
        n = int(np.abs(px[b] - px[a]).max()) * 2 + 2
        seg = px[a] + (px[b] - px[a]) * np.linspace(0, 1, n)[:, None]
        xy = np.round(seg).astype(int)
        keep = ((xy[:, 0] >= 0) & (xy[:, 0] < size)
                & (xy[:, 1] >= 0) & (xy[:, 1] < size))
        out[xy[keep, 1], xy[keep, 0]] = color
    return out


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


class ViewerSession:
    """Holds a loaded run and renders view-panel frames on demand, on the
    device its parameters are on, or split over ``devices``
    (``render_camera``'s)."""

    def __init__(self, params, config, scene_aabb=None, devices=None):
        self.params = params
        self.config = config
        self.devices = devices
        self.device = params["model"]["field"]["base_mlp"]["w0"].device
        # Preview config: ~4x fewer samples/ray for interactive orbiting.
        # Sample counts are sampling shapes, not parameters, so the same
        # params render under both configs; the client requests preview
        # frames during drag and a debounced full frame after (the
        # nerfstudio viewer's adaptive-resolution trick, viewer chunk 1<<13
        # fruit_nerf_config.py:57).
        self.preview_config = dataclasses.replace(
            config,
            model=dataclasses.replace(
                config.model,
                num_nerf_samples=max(config.model.num_nerf_samples // 3, 8),
                num_proposal_samples=tuple(
                    max(n // 4, 16) for n in config.model.num_proposal_samples
                ),
            ),
        )
        self.scene_aabb = (np.asarray(scene_aabb, np.float32)
                          if scene_aabb is not None
                          else np.array([[-1.0] * 3, [1.0] * 3], np.float32))
        self._lock = threading.Lock()  # one render at a time on the device

    @classmethod
    def from_run_dir(cls, run_dir, device, devices=None):
        """A trained run restored through ``engine/runs.py:load_run`` (the
        manifest's overrides applied, its layout checked) onto ``device``."""
        from ..engine.runs import load_run

        manifest, config, state = load_run(run_dir, device)
        return cls(state.params, config, scene_aabb=manifest.get("scene_aabb"),
                   devices=devices)

    def render_frame(self, theta, phi, radius, size, panel="rgb",
                     crop: np.ndarray | None = None,
                     preview: bool = False) -> np.ndarray:
        from ..engine.trainer import render_camera

        cameras = orbit_camera(theta, phi, radius, size, device=self.device)
        config = self.preview_config if preview else self.config
        # grad mode is per thread: a handler thread enters inference mode
        # itself; the lock keeps one render and its read-back on the device
        with self._lock, torch.inference_mode():
            panels = render_camera(self.params, cameras, 0, config, self.devices)
            if panel == "rgb":
                x = panels["rgb"].cpu().numpy()
            elif panel == "semantics":
                x = panels["semantics_colormap"][..., 0].cpu().numpy()
            elif panel == "depth":
                x = panels["depth"].cpu().numpy()
            else:  # accumulation
                x = panels["accumulation"].cpu().numpy()
        if panel == "rgb":
            img = _to_u8(x)
        elif panel == "depth":
            lo, hi = np.percentile(x, 2), np.percentile(x, 98)
            img = _to_u8(np.stack([(x - lo) / max(hi - lo, 1e-6)] * 3, -1))
        else:  # semantics, accumulation
            img = _to_u8(np.stack([x, x, x], -1))
        if crop is not None:
            img = draw_crop_box(img, cameras, crop)
        return img

    def suggest_crop(self, n=64):
        from ..scripts.suggest_crop import occupancy_grids, occupied_aabb

        with self._lock:
            occ_d, occ_s = occupancy_grids(
                self.params["model"], self.config.model, n=n,
                density_thr=70.0, logit_thr=3.0)
        aabb = occupied_aabb(occ_s if occ_s.any() else occ_d, pad_cells=2)
        return None if aabb is None else aabb.tolist()


_PAGE = """<!doctype html><html><head><title>fruitnerf_tpu_torch viewer</title><style>
body{font-family:sans-serif;background:#151515;color:#ddd;margin:0;display:flex}
#side{width:280px;padding:14px}#view{flex:1;text-align:center;padding:10px}
img{image-rendering:pixelated;max-width:90vmin;width:90vmin;cursor:grab}
input[type=range]{width:240px}label{font-size:12px}
pre{background:#222;padding:8px;font-size:11px;white-space:pre-wrap}
button,select{margin:4px 0}</style></head><body>
<div id=side>
<h3>fruitnerf_tpu_torch</h3>
<label>panel <select id=panel><option>rgb</option><option>semantics</option>
<option>depth</option><option>accumulation</option></select></label><br>
<label>size <select id=size><option>128</option><option selected>256</option>
<option>512</option></select></label><br>
<label><input type=checkbox id=showcrop checked> crop box</label>
<div id=sliders></div>
<button id=suggest>suggest crop (occupancy probe)</button>
<pre id=cmd></pre><div id=stat></div></div>
<div id=view><img id=img width=512 height=512></div>
<script>
let th=0.8, ph=0.5, r=2.5, busy=false, queued=false;
let crop=[[-1,-1,-1],[1,1,1]];
const axes=['x','y','z'];
const sl=document.getElementById('sliders');
sl.innerHTML = [0,1].map(k=>axes.map((a,i)=>
 `<label>${k?'max':'min'} ${a} <input type=range min=-1 max=1 step=0.02
  value=${k?1:-1} data-k=${k} data-i=${i}></label>`).join('<br>')).join('<br>');
function cmdline(){
 document.getElementById('cmd').textContent =
  'export --bounding-box-min '+crop[0].map(v=>v.toFixed(2)).join(' ')+
  ' --bounding-box-max '+crop[1].map(v=>v.toFixed(2)).join(' ');}
cmdline();
let fullTimer=null;
function refresh(preview){
 if(busy){queued=true;return;} busy=true;
 const t0=performance.now();
 let size=document.getElementById('size').value;
 const panel=document.getElementById('panel').value;
 // progressive: during interaction render small + few samples, then
 // schedule the full-quality frame once the user pauses
 if(preview){size=Math.min(size,128);}
 let u=`/render?theta=${th}&phi=${ph}&radius=${r}&size=${size}`+
       `&panel=${panel}&preview=${preview?1:0}`;
 if(document.getElementById('showcrop').checked)
   u+='&crop='+crop.flat().join(',');
 const img=document.getElementById('img');
 fetch(u).then(r=>r.blob()).then(b=>{
  img.src=URL.createObjectURL(b); busy=false;
  document.getElementById('stat').textContent=
   ((performance.now()-t0)/1000).toFixed(2)+' s/frame'+
   (preview?' (preview)':'');
  if(queued){queued=false;refresh(true);}});
 if(preview){clearTimeout(fullTimer);
  fullTimer=setTimeout(()=>refresh(false),400);}
 else clearTimeout(fullTimer);}
sl.querySelectorAll('input').forEach(e=>e.oninput=()=>{
 crop[e.dataset.k][e.dataset.i]=parseFloat(e.value);cmdline();refresh(true);});
document.querySelectorAll('#panel,#size,#showcrop').forEach(
 e=>e.onchange=()=>refresh(false));
const img=document.getElementById('img');
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault();};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
 th-=(e.clientX-drag[0])*0.01; ph=Math.min(1.5,Math.max(-0.2,
 ph+(e.clientY-drag[1])*0.01)); drag=[e.clientX,e.clientY]; refresh(true);};
img.onwheel=e=>{e.preventDefault();r=Math.min(8,Math.max(0.3,
 r*(e.deltaY>0?1.1:0.9)));refresh(true);};
document.getElementById('suggest').onclick=()=>{
 document.getElementById('stat').textContent='probing...';
 fetch('/suggest').then(r=>r.json()).then(j=>{
  if(j.aabb){crop=j.aabb;
   sl.querySelectorAll('input').forEach(e=>
    e.value=crop[e.dataset.k][e.dataset.i]);
   cmdline();} refresh();});};
refresh();
</script></body></html>"""


def _make_handler(session: ViewerSession):
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif url.path == "/render":
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    crop = None
                    if "crop" in q:
                        crop = np.array(
                            [float(x) for x in q["crop"].split(",")]
                        ).reshape(2, 3)
                    img = session.render_frame(
                        float(q.get("theta", 0.8)), float(q.get("phi", 0.5)),
                        float(q.get("radius", 2.5)),
                        min(int(q.get("size", 256)), 1024),
                        q.get("panel", "rgb"), crop,
                        preview=q.get("preview", "0") == "1")
                    buf = io.BytesIO()
                    Image.fromarray(img).save(buf, "PNG")
                    self._send(200, buf.getvalue(), "image/png")
                elif url.path == "/suggest":
                    aabb = session.suggest_crop()
                    self._send(200, json.dumps({"aabb": aabb}).encode(),
                               "application/json")
                elif url.path == "/info":
                    self._send(200, json.dumps({
                        "preset": session.config.preset,
                        "panels": _PANELS,
                        "scene_aabb": session.scene_aabb.tolist(),
                    }).encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:  # surface render errors to the client
                self._send(500, str(e).encode(), "text/plain")

    return Handler


def serve(session: ViewerSession, port: int = 7007,
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the viewer server (non-blocking; returns the server object)."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(session))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def add_args(p):
    p.add_argument("--load-dir", required=True, help="run dir with manifest")
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--mesh", action="store_true",
        help="shard each frame's rays over all visible devices",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "asks for the CPU explicitly)")


def main(args):
    from ..utils import mesh_devices, resolve_device

    dev = resolve_device(args.device)
    session = ViewerSession.from_run_dir(args.load_dir, dev,
                                         mesh_devices(dev) if args.mesh else None)
    httpd = serve(session, port=args.port, host=args.host)
    print(f"viewer at http://{args.host}:{args.port}/  (ctrl-c to stop)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
