"""Interactive multi-scene viewer, served over HTTP.

Port of ``taichi_3d_gaussian_splatting_tpu/apps/visualizer.py``, the same
interaction model: each loaded scene is an object with its own camera
pose, fed to the rasterizer as per-object (K, 4)/(K, 3) poses; keys 0-9
select the camera (0) or an object; WASD/QE/-/= move or turn the camera,
or the selected object with the sign flipped; a mouse drag orbits the
camera or spins the selected object about its centre; H/P hide and show
through the invalid mask. A browser posts key and drag events to /event
and pulls JPEG frames from /frame; each frame is one ``rasterize`` call
on ``device`` (the card by default; ``--device cpu`` runs the kernels'
plain versions).

    python -m taichi_3d_gaussian_splatting_tpu_torch.apps.visualizer \\
        --parquet_path_list a.parquet b.ply --port 8000
"""
from __future__ import annotations

import argparse
import io
import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.apps.render import load_scene
from taichi_3d_gaussian_splatting_tpu_torch.models.scene import merge_scenes
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    Camera,
    RasterizerConfig,
    pin_f32_matmul,
    rasterize,
)

TILE = 32


def _np_quat_multiply(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


def _np_quat_rotate(q, v):
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def _np_quat_conj(q):
    return q * np.asarray([-1.0, -1.0, -1.0, 1.0], q.dtype)


@dataclass
class VisualizerConfig:
    """The viewer's scenes, viewport, intrinsics and step sizes."""

    parquet_paths: List[str] = field(default_factory=list)
    image_height: int = 544
    image_width: int = 992
    camera_intrinsics: Optional[np.ndarray] = None
    step_size: float = 0.1
    mouse_sensitivity: float = 3.0
    port: int = 8000

    def __post_init__(self):
        if self.camera_intrinsics is None:
            self.camera_intrinsics = np.asarray(
                [[500.0, 0.0, self.image_width / 2],
                 [0.0, 500.0, self.image_height / 2],
                 [0.0, 0.0, 1.0]], np.float32)


class GaussianPointVisualizer:
    """The viewer's state machine and its renderer, on ``device``. The
    scenes come from ``_load_scenes`` (.parquet or .ply files), which a
    caller may replace, e.g. with scenes held in memory."""

    def __init__(self, config: VisualizerConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.height = config.image_height - config.image_height % TILE
        self.width = config.image_width - config.image_width % TILE
        pin_f32_matmul()
        scenes = self._load_scenes()
        self.num_objects = len(scenes)
        self.object_ranges = []
        self.object_centers = []
        off = 0
        for s in scenes:
            self.object_ranges.append((off, off + s.capacity))
            self.object_centers.append(s.xyz.cpu().numpy().mean(axis=0))
            off += s.capacity
        self.scene = merge_scenes(scenes) if len(scenes) > 1 else scenes[0]

        k = self.num_objects
        # per-object poses: row i is the camera pose of the points with
        # object_id == i
        self.q = np.tile(np.asarray([0, 0, 0, 1], np.float32), (k, 1))
        self.t = np.zeros((k, 3), np.float32)
        self.selected = 0  # 0 = camera, 1..k = object
        self.lock = threading.Lock()
        self.camera = Camera(
            K=torch.as_tensor(np.asarray(config.camera_intrinsics,
                                         np.float32), device=self.device),
            width=self.width, height=self.height)
        self.rcfg = RasterizerConfig(tile_size=TILE, rgb_only=True)
        self._invalid = self.scene.invalid.cpu().numpy().copy()

    def _load_scenes(self) -> list:
        return [load_scene(p, self.device) for p in self.config.parquet_paths]

    # -- event handling -----------------------------------------------------

    def _selection(self):
        if self.selected == 0:
            return np.arange(self.num_objects), 1.0
        return np.asarray([self.selected - 1]), -1.0

    def handle_key(self, key: str) -> None:
        with self.lock:
            sel, move_factor = self._selection()
            step = self.config.step_size
            if key.isdigit():
                idx = int(key)
                if idx <= self.num_objects:
                    self.selected = idx
                return
            if key in ("w", "s", "a", "d", "-", "="):
                axis = {"w": 2, "s": 2, "a": 0, "d": 0, "-": 1, "=": 1}[key]
                sign = {"w": 1, "s": -1, "a": -1, "d": 1, "-": 1, "=": -1}[key]
                delta = np.zeros((len(sel), 3), np.float32)
                delta[:, axis] = step * sign * move_factor
                self.t[sel] += _np_quat_rotate(self.q[sel], delta)
            elif key in ("q", "e"):
                sign = -1.0 if key == "q" else 1.0
                half = sign * step / 2 * move_factor
                dq = np.zeros((len(sel), 4), np.float32)
                dq[:, 3] = np.cos(half)
                dq[:, 1] = np.sin(half)
                qn = _np_quat_multiply(self.q[sel], dq)
                self.q[sel] = qn / np.linalg.norm(qn, axis=-1, keepdims=True)
            elif key == "h":
                lo, hi = self._selected_range()
                self._invalid[lo:hi] = True
            elif key == "p":
                lo, hi = self._selected_range()
                self._invalid[lo:hi] = False

    def _selected_range(self):
        if self.selected == 0:
            return 0, self.scene.capacity
        return self.object_ranges[self.selected - 1]

    def handle_drag(self, dx: float, dy: float) -> None:
        """Mouse orbit: turns the camera, or spins the selected object
        about its own centre."""
        with self.lock:
            sel, _ = self._selection()
            angle_x = dx * self.config.mouse_sensitivity
            angle_y = dy * self.config.mouse_sensitivity
            object_selected = self.selected != 0
            if object_selected:
                center = self.object_centers[self.selected - 1][None]
                cam_to_center = _np_quat_rotate(
                    _np_quat_conj(self.q[sel]), center - self.t[sel])
            for angle, axis in ((angle_y, 1), (angle_x, 0)):
                dq = np.zeros((len(sel), 4), np.float32)
                dq[:, 3] = np.cos(angle / 2)
                dq[:, axis] = np.sin(angle / 2)
                qn = _np_quat_multiply(self.q[sel], dq)
                self.q[sel] = qn / np.linalg.norm(qn, axis=-1, keepdims=True)
            if object_selected:
                new_center = _np_quat_rotate(self.q[sel], cam_to_center)
                self.t[sel] = center - new_center

    # -- rendering ------------------------------------------------------------

    @torch.no_grad()
    def render_frame(self) -> torch.Tensor:
        """The current view, (H, W, 3) f32 in [0, 1] on the device. Frames
        render one at a time under the lock, on the device's default
        stream, which the server's handler threads share."""
        with self.lock:
            put = lambda a: torch.from_numpy(a.copy()).to(self.device)  # noqa: E731
            s = self.scene
            out = rasterize(s.xyz, s.features, put(self._invalid),
                            put(self.q), put(self.t), self.camera, self.rcfg,
                            sh_max_band=3, point_object_id=s.object_id)
            return torch.clamp(out.rgb, 0.0, 1.0)

    def frame_jpeg(self) -> bytes:
        from PIL import Image

        rgb = self.render_frame().cpu().numpy()
        img = Image.fromarray((rgb * 255).astype(np.uint8), "RGB")
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90)
        return buf.getvalue()


_PAGE = """<!doctype html><html><head><title>3DGS viewer</title><style>
body{margin:0;background:#111;color:#ccc;font-family:monospace}
#hud{position:fixed;top:4px;left:8px}</style></head><body>
<div id=hud>WASD/QE move/rotate &middot; drag orbits &middot; 0-9 select
scene &middot; H/P hide/show</div>
<img id=v draggable=false style="display:block;margin:auto"/>
<script>
const img=document.getElementById('v');let drag=null;
async function loop(){img.src='/frame?'+Date.now();}
img.onload=()=>setTimeout(loop,30);
img.onerror=()=>setTimeout(loop,1000);  // keep polling through hiccups
loop();
async function ev(b){await fetch('/event',{method:'POST',body:JSON.stringify(b)})}
window.onkeydown=e=>ev({key:e.key.toLowerCase()});
img.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
  /* clientY grows down and the orbit's vertical axis up: the vertical
     drag flips sign */
  ev({dx:-(e.clientY-drag[1])/img.height,dy:(e.clientX-drag[0])/img.width});
  drag=[e.clientX,e.clientY];};
</script></body></html>"""


def make_server(vis: GaussianPointVisualizer, port: int,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """The HTTP server (port 0 binds an ephemeral port; read it from
    ``server.server_address``)."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.startswith("/frame"):
                data = vis.frame_jpeg()
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.end_headers()
                self.wfile.write(data)
            else:
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(_PAGE.encode())

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or "{}")
            if "key" in body:
                vis.handle_key(body["key"])
            elif "dx" in body:
                vis.handle_drag(float(body["dx"]), float(body["dy"]))
            self.send_response(204)
            self.end_headers()

    # loopback by default: the server exposes unauthenticated scene control
    # and rendering; reach it over SSH port-forwarding, or bind wider with
    # --host
    return ThreadingHTTPServer((host, port), Handler)


def serve(vis: GaussianPointVisualizer, port: int,
          host: str = "127.0.0.1") -> None:
    server = make_server(vis, port, host)
    print(f"viewer at http://localhost:{server.server_address[1]}/ "
          f"(bound to {host})")
    server.serve_forever()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--parquet_path_list", type=str, nargs="+",
                        required=True,
                        help="scene files (.parquet or graphdeco .ply)")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", type=str, default="127.0.0.1",
                        help="bind address (default loopback; the viewer "
                        "is unauthenticated — prefer SSH port-forwarding "
                        "over 0.0.0.0)")
    parser.add_argument("--ftgmm", action="store_true", default=False,
                        help="run the GMM Fourier analysis at startup")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions "
                        "of the kernels")
    args = parser.parse_args(argv)
    config = VisualizerConfig(parquet_paths=args.parquet_path_list,
                              port=args.port)
    vis = GaussianPointVisualizer(config, device=args.device)
    if args.ftgmm:
        from taichi_3d_gaussian_splatting_tpu_torch.tools.ftgmm import (
            ft_grab_scene,
        )

        print("ftgmm:", ft_grab_scene(vis.scene))
    serve(vis, args.port, host=args.host)


if __name__ == "__main__":
    main()
