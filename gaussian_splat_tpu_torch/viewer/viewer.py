"""Headless interactive viewer: device-rendered frames + live metrics.

Counterpart of gaussian_splat_tpu/viewer/viewer.py.

  * `Viewer.render_frame()` — one camera→uint8 image step with frame timing,
    in color / depth / alpha modes, over the grid/axes overlay, rendering the
    level-of-detail subset while the camera is being dragged.
  * `Viewer.orbit_turntable()` — offline turntable render (frames or PNG dir).
  * `Viewer.serve()` — zero-dependency MJPEG HTTP server (stdlib only): open
    http://host:port/ for a live view with click-drag orbit / wheel zoom via
    fetch callbacks.

With `hot_reload` the viewer polls the CUDA sources (csrc/) before every
frame and swaps in rebuilt kernels, keeping the last good build
(utils/hot_reload.py).

Frames are serialised by a lock: the HTTP server answers each request on its
own thread, and two frames at once would race on `last_output`, the timers
and the kernels' launch counts. Timers: "frame" (the render), "overlay" (its
layer and composite), "jpeg" (a served frame's encode, on the host).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import threading
import time
from typing import Optional

import numpy as np
import torch

from gaussian_splat_tpu_torch._device import DeviceLike, require_device
from gaussian_splat_tpu_torch.camera import Camera, orbit_camera
from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.render import measure_pair_costs, render
from gaussian_splat_tpu_torch.utils.timing import ScopeTimer
from gaussian_splat_tpu_torch.viewer import overlay as _ov
from gaussian_splat_tpu_torch.viewer.trackball import TrackballCamera

INTERACTION_HOLD_S = 0.4  # the LoD subset is drawn until this long after an input


def to_uint8(image: torch.Tensor) -> np.ndarray:
    return torch.clamp(image * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()


def encode_jpeg(frame: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class Viewer:
    """Serves frames of `model` on `device` (None: the GPU), where the model
    must already lie."""

    def __init__(
        self,
        model: GaussianModel,
        config: RenderConfig = RenderConfig(),
        width: int = 1280,
        height: int = 720,
        overlay_objects: Optional[list] = None,  # default: grid(10) + axes(2)
        show_overlay: bool = True,
        hot_reload=False,  # True: watch csrc/ and hot-swap rebuilt kernels,
        #   keeping the last good build; a directory: watch its sources instead
        background=(0.1, 0.1, 0.15),
        lod_fraction: float = 0.0,  # >0: render the top-impact subset
        #   (GaussianModel.lod) while the camera is being dragged/zoomed and
        #   the full model once idle
        lod_pair_budget: float = 0.0,  # >0: pair-budget drag subset instead —
        #   per-splat tile costs measured at the start pose
        #   (ops.render.measure_pair_costs), subset bounded to this fraction of
        #   the frame's tile-pair cost (GaussianModel.lod_pair_budget). Takes
        #   precedence.
        device: DeviceLike = None,
    ):
        self.device = require_device(model.device, device)
        self.model = model
        self.config = config
        self.width = width
        self.height = height
        self.mode = "color"  # "color" | "depth" | "alpha" debug views
        self.background = background
        self.trackball = TrackballCamera()
        self.timers = ScopeTimer(self.device)
        self.last_output = None  # RenderOutput of the newest frame (over black)
        self.last_frame_lod = False  # whether the newest frame drew the subset
        self._lock = threading.RLock()
        self.lod_fraction = lod_fraction
        self.lod_pair_budget = lod_pair_budget
        if 0.0 < lod_pair_budget < 1.0:
            cam0 = self.trackball.camera(width, height, self.device)
            costs = measure_pair_costs(model, cam0, config, device=self.device)
            self._model_lod = model.lod_pair_budget(lod_pair_budget, costs)
        elif 0.0 < lod_fraction < 1.0:
            self._model_lod = model.lod(lod_fraction)
        else:
            self._model_lod = None
        self._interacting_until = 0.0

        if overlay_objects is None:
            overlay_objects = [_ov.grid(10, 1.0), _ov.axes(2.0)]
        self.overlay_objects = overlay_objects
        self.show_overlay = show_overlay

        # splats are rendered over BLACK so T_final carries the residual for
        # the overlay/background composite
        self._render_config = dataclasses.replace(config, background=(0.0, 0.0, 0.0))
        self._background = torch.tensor(
            background, dtype=torch.float32, device=self.device
        )

        self._reloader = None
        if hot_reload:
            from gaussian_splat_tpu_torch.utils.hot_reload import HotReloader

            probe_cam = self.trackball.camera(width, height, self.device)
            self._reloader = HotReloader(
                probe=lambda: self._probe(probe_cam),
                src_dir=None if hot_reload is True else hot_reload,
            )

    def _device_scope(self):
        # an HTTP handler thread starts on CUDA device 0: use the viewer's
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @torch.no_grad()
    def _probe(self, cam: Camera) -> None:
        """A hot reload's probe frame: must finish on the device and be finite."""
        out = render(self.model, cam, self._render_config)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if not bool(torch.isfinite(out.image).all()):
            raise FloatingPointError("probe frame is not finite")

    def touch(self) -> None:
        """An input arrived: draw the LoD subset for the next moments."""
        if self._model_lod is not None:
            self._interacting_until = time.monotonic() + INTERACTION_HOLD_S

    # -- single frame --------------------------------------------------------
    @torch.no_grad()
    def render_frame(self, camera: Optional[Camera] = None) -> np.ndarray:
        with self._lock, self._device_scope():
            if self._reloader is not None:
                # per-frame poll of the sources; a cheap stat when unchanged
                self._reloader.check()
            cam = camera or self.trackball.camera(self.width, self.height, self.device)
            model = self.model
            self.last_frame_lod = (
                self._model_lod is not None and time.monotonic() < self._interacting_until
            )
            if self.last_frame_lod:
                model = self._model_lod
            with self.timers.scope("frame"):
                out = render(model, cam, self._render_config)
            self.last_output = out
            image, alpha, depth = out.image, out.alpha, out.depth
            if self.mode == "color":
                if self.show_overlay and self.overlay_objects:
                    with self.timers.scope("overlay"):
                        ov_rgb, ov_cov = _ov.render_overlay(self.overlay_objects, cam)
                        image = _ov.composite_over_background(
                            image, 1.0 - alpha, ov_rgb, ov_cov, self.background
                        )
                else:
                    image = image + (1.0 - alpha)[..., None] * self._background
            elif self.mode == "alpha":
                image = alpha[..., None].expand(-1, -1, 3)
            elif self.mode == "depth":
                # normalized inverse-depth heat view (near = bright)
                d = depth / torch.clamp_min(alpha, 1e-6)
                inv = torch.where(alpha > 0.05, 1.0 / torch.clamp_min(d, 1e-3), 0.0)
                inv = inv / torch.clamp_min(inv.max(), 1e-6)
                image = torch.stack([inv, inv * 0.6, 1.0 - inv], dim=-1) * (
                    alpha[..., None] > 0.05
                )
            return to_uint8(image)

    @property
    def last_stats(self):
        """BinningStats of the newest frame (None before the first)."""
        return None if self.last_output is None else self.last_output.stats

    def resize(self, width: int, height: int) -> None:
        """Change the viewport; externally-supplied cameras can use
        `Camera.resized` for the same intrinsics scaling."""
        self.width = max(16, int(width))
        self.height = max(16, int(height))

    def metrics(self) -> dict:
        frame = self.timers.stats.get("frame")
        ms = frame.mean if frame else 0.0
        return {
            "fps": 1000.0 / ms if ms > 0 else 0.0,
            "frame_ms": ms,
            "num_gaussians": self.model.num_gaussians,
            "resolution": [self.width, self.height],
            "camera_position": [float(v) for v in self.trackball.position],
        }

    # -- offline turntable ---------------------------------------------------
    def orbit_turntable(
        self,
        n_frames: int = 60,
        radius: float = 5.0,
        elevation_deg: float = 20.0,
        out_dir: Optional[str] = None,
    ):
        """Render an orbit; optionally save PNG frames. Returns the frames."""
        frames = []
        for i in range(n_frames):
            cam = orbit_camera(
                radius, 360.0 * i / n_frames, elevation_deg,
                width=self.width, height=self.height, device=self.device,
            )
            frames.append(self.render_frame(cam))
        if out_dir is not None:
            import os

            from PIL import Image

            os.makedirs(out_dir, exist_ok=True)
            for i, f in enumerate(frames):
                Image.fromarray(f).save(f"{out_dir}/frame_{i:04d}.png")
        return frames

    # -- live HTTP viewer ----------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 8000, block: bool = True):
        """Serve a live MJPEG view with mouse orbit/zoom controls. With
        `block=False` the server runs on a daemon thread and is returned:
        stop it with `shutdown()` and `server_close()`."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, body: bytes, content_type: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(_INDEX_HTML.encode(), "text/html")
                elif self.path.startswith("/frame"):
                    with viewer._lock:
                        frame = viewer.render_frame()
                        with viewer.timers.scope("jpeg"):
                            body = encode_jpeg(frame)
                    self._send(body, "image/jpeg")
                elif self.path == "/metrics":
                    self._send(json.dumps(viewer.metrics()).encode(), "application/json")
                elif self.path.startswith("/input"):
                    q = parse_qs(urlparse(self.path).query)
                    kind = q.get("kind", [""])[0]
                    tb = viewer.trackball
                    if kind in ("down", "move", "scroll"):
                        viewer.touch()
                    if kind == "down":
                        tb.handle_mouse_down(
                            float(q["x"][0]), float(q["y"][0]), int(q.get("b", ["0"])[0])
                        )
                    elif kind == "move":
                        tb.handle_mouse_move(
                            float(q["x"][0]), float(q["y"][0]), viewer.height
                        )
                    elif kind == "up":
                        tb.handle_mouse_up()
                    elif kind == "scroll":
                        tb.handle_scroll(float(q["dy"][0]))
                    elif kind == "mode":
                        m = q.get("m", ["color"])[0]
                        if m in ("color", "depth", "alpha"):
                            viewer.mode = m
                    elif kind == "overlay":
                        viewer.show_overlay = not viewer.show_overlay
                    elif kind == "resize":
                        w = int(q.get("w", [viewer.width])[0])
                        h = int(q.get("h", [viewer.height])[0])
                        viewer.resize(w, h)
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        if not block:
            threading.Thread(target=server.serve_forever, daemon=True).start()
            return server
        try:
            server.serve_forever()
        finally:
            server.server_close()


_INDEX_HTML = """<!doctype html>
<html><head><title>gaussian_splat_tpu_torch viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px 10px;border-radius:4px}
img{display:block;margin:auto;max-width:100vw;max-height:100vh}
</style></head><body>
<div id="hud">loading…</div><img id="view" draggable="false">
<script>
const img=document.getElementById('view'),hud=document.getElementById('hud');
let busy=false;
async function refresh(){if(busy)return;busy=true;
 img.src='/frame?t='+Date.now();
 await new Promise(r=>{img.onload=r;img.onerror=r});busy=false;}
setInterval(refresh,66);refresh();
setInterval(async()=>{const m=await(await fetch('/metrics')).json();
 hud.textContent=`${m.fps.toFixed(1)} fps  ${m.frame_ms.toFixed(1)} ms  `+
   `${m.num_gaussians} splats  cam ${m.camera_position.map(v=>v.toFixed(2))}`;},500);
const send=p=>fetch('/input?'+p);
img.addEventListener('mousedown',e=>send(`kind=down&x=${e.clientX}&y=${e.clientY}&b=${e.button}`));
window.addEventListener('mousemove',e=>send(`kind=move&x=${e.clientX}&y=${e.clientY}`));
window.addEventListener('mouseup',()=>send('kind=up'));
img.addEventListener('wheel',e=>{e.preventDefault();send(`kind=scroll&dy=${Math.sign(e.deltaY)}`)});
img.addEventListener('contextmenu',e=>e.preventDefault());
window.addEventListener('keydown',e=>{
 if(e.key==='g'){send('kind=overlay');return;}
 const m={c:'color',d:'depth',a:'alpha'}[e.key];
 if(m)send('kind=mode&m='+m);});
let rt=null;
window.addEventListener('resize',()=>{clearTimeout(rt);
 rt=setTimeout(()=>send(`kind=resize&w=${window.innerWidth}&h=${window.innerHeight}`),300);});
</script></body></html>
"""
