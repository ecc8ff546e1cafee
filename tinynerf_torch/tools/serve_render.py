"""The render service: free-viewpoint frames of a trained checkpoint over HTTP.

Counterpart of ``tools/serve_render.py``. It resumes the latest checkpoint of
a config (refusing fresh weights) and serves

- ``GET /``: a viewer page, sliders for azimuth, elevation, radius, scale
  and view driving the frame route;
- ``GET /frame?theta=&elev=&radius=&scale=&view=rgb|depth|acc``: one JPEG
  from that viewpoint (an LLFF rig: the position along the standard spiral;
  any other rig: ``data.paths.free_pose``, an inward orbit or an outward
  pan);
- ``GET /info``: the run's metadata as JSON; its ``backend`` is the torch
  device.

Scales snap to a fixed ladder, so at most five frame functions are made (one
per ``(height, width, extras)``, by ``eval.make_frame_fn`` with the Runner's
occupancy grid and ``ndc_params``), and a frame under 4 pixels is refused.
Renders are serialised by a lock. A frame's array (``Service.render_u8``)
sits apart from its JPEG encoding (``encode_jpeg``, the port's own encoder,
``data/imagefile.py``: no Pillow). The port renders chunk by chunk from the host
always, so the JAX tool's ``--lax-map`` and ``--chunk-group`` have no
counterpart.

Usage (on the card unless ``--cpu``):

    python -m tinynerf_torch.tools.serve_render --conf conf/lego.ini --port 8008
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from tinynerf_torch import eval as evallib
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data import imagefile, paths

_PAGE = """<!doctype html>
<html><head><title>tinynerf viewer</title><style>
 body {{ font-family: sans-serif; margin: 2em; background: #111; color: #eee }}
 img {{ image-rendering: pixelated; width: 512px; border: 1px solid #444 }}
 label {{ display: inline-block; width: 6em }}
 .row {{ margin: 0.4em 0 }}
</style></head><body>
<h2>tinynerf &mdash; {scene} (iter {it})</h2>
<img id="v" src="/frame">
<div class="row"><label>azimuth</label>
 <input type="range" id="theta" min="0" max="360" value="0" step="3"></div>
<div class="row"><label>elevation</label>
 <input type="range" id="elev" min="-80" max="80" value="{elev}" step="2"></div>
<div class="row"><label>radius</label>
 <input type="range" id="radius" min="50" max="200" value="100" step="5"></div>
<div class="row"><label>scale</label>
 <select id="scale"><option>0.125</option><option selected>0.25</option>
 <option>0.5</option><option>1.0</option></select></div>
<div class="row"><label>view</label>
 <select id="view"><option selected>rgb</option><option>depth</option>
 <option>acc</option></select></div>
<script>
 const ids = ["theta", "elev", "radius", "scale", "view"];
 let busy = false, dirty = false;
 function refresh() {{
   if (busy) {{ dirty = true; return; }}
   busy = true;
   const q = new URLSearchParams({{
     theta: theta.value, elev: elev.value,
     radius: radius.value / 100, scale: scale.value, view: view.value }});
   const img = new Image();
   img.onload = () => {{ v.src = img.src; busy = false;
                         if (dirty) {{ dirty = false; refresh(); }} }};
   img.onerror = () => {{ busy = false; }};
   img.src = "/frame?" + q;
 }}
 ids.forEach(i => document.getElementById(i).addEventListener("input", refresh));
 refresh();
</script></body></html>"""

# a client's scale snaps to this ladder: at most five frame functions
SCALES = (0.125, 0.25, 0.5, 1.0, 2.0)
MIN_FRAME_PX = 4
VIEWS = ("rgb", "depth", "acc")


def encode_jpeg(u8: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> JPEG bytes (``imagefile.write_jpeg``)."""
    return imagefile.write_jpeg(None, u8, quality)


class Service:
    """A trained Runner's frames: the pose of a viewpoint, one frame
    function per resolution and view kind, and the frames as uint8
    arrays."""

    def __init__(self, cfg, runner):
        self.cfg = cfg
        self.runner = runner
        self.pose_rows = runner.train_table.poses.cpu().numpy()
        self._frame_fns = {}
        self._spiral = None
        self.lock = threading.Lock()

    def pose(self, theta: float, elev: Optional[float], radius: float,
             scale: float) -> np.ndarray:
        """The (17,) pose row of a viewpoint: on an LLFF rig ``theta`` indexes
        the 120-view spiral; elsewhere ``paths.free_pose``."""
        if self.cfg.data_type == "llff":
            if self._spiral is None or self._spiral[0] != scale:
                self._spiral = (scale, paths.spiral_path(self.pose_rows, n_views=120,
                                                         res_scale=scale))
            return self._spiral[1][int(theta / 360.0 * 120) % 120]
        return paths.free_pose(self.pose_rows, theta, elev_deg=elev,
                               radius_scale=radius, res_scale=scale)

    def frame_fn(self, hwf, extras: bool = False):
        """The frame function of an (h, w, focal) view, made once per
        ``(h, w, extras)``."""
        h, w = int(hwf[0]), int(hwf[1])
        key = (h, w, extras)
        if key not in self._frame_fns:
            k_inv = make_k_inv(float(hwf[0]), float(hwf[1]), float(hwf[2]),
                               self.runner.device)
            self._frame_fns[key] = evallib.make_frame_fn(
                self.cfg, k_inv, h, w, extras=extras, occ_grid=self.runner.state.occ,
                ndc_params=self.runner.ndc_params)
        return self._frame_fns[key]

    def rig_elev_deg(self) -> float:
        """The training rig's mean elevation in degrees (0 on an LLFF rig,
        where the slider indexes the spiral)."""
        if self.cfg.data_type == "llff":
            return 0.0
        return float(np.rad2deg(paths._orbit_geometry(self.pose_rows)[1]))

    def snap_scale(self, scale: float) -> float:
        """``scale`` snapped to the ladder; a frame under 4 pixels raises."""
        scale = min(SCALES, key=lambda s: abs(s - scale))
        h0 = min(self.runner.train_table.height, self.runner.train_table.width)
        if int(h0 * scale) < MIN_FRAME_PX:
            raise ValueError(f"scale {scale} gives a {int(h0 * scale)}px frame; "
                             f"minimum is {MIN_FRAME_PX}px")
        return scale

    def render_u8(self, theta: float = 0.0, elev: Optional[float] = None,
                  radius: float = 1.0, scale: float = 0.25, view: str = "rgb") -> np.ndarray:
        """One frame as uint8: (H, W, 3) for ``rgb``; (H, W) for ``depth``
        (near/far-normalised expected termination, white near, NDC units
        under NDC) and ``acc``."""
        if view not in VIEWS:
            raise ValueError(f"view={view!r}: rgb|depth|acc")
        row = self.pose(theta, elev, radius, self.snap_scale(scale))
        hwf = row[:15].reshape(3, 5)[:, 4]
        extras = view != "rgb"
        with self.lock:
            out = self.frame_fn(hwf, extras=extras)(self.runner.params, row)
        if not extras:
            return (np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)
        _, depth, acc = out
        if view == "depth":
            near, far = ((0.0, 1.0) if self.runner.ndc_params is not None
                         else (float(row[15]), float(row[16])))
            frame = 1.0 - np.clip((depth - near) / max(far - near, 1e-6), 0.0, 1.0)
        else:
            frame = np.clip(acc, 0.0, 1.0)
        return (frame * 255.0).astype(np.uint8)

    def info(self) -> dict:
        cfg, table = self.cfg, self.runner.train_table
        return {
            "scene": os.path.basename(os.path.normpath(cfg.img_dir)),
            "data_type": cfg.data_type,
            "iteration": int(self.runner.last_iter),
            "fine_field": cfg.fine_field,
            "proposal": bool(cfg.proposal),
            "occ_grid": bool(cfg.occ_grid),
            "height": int(table.height),
            "width": int(table.width),
            "backend": str(self.runner.device),   # the torch device
        }


def make_handler(svc: Service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # one line per request
            sys.stderr.write("%s %s\n" % (self.address_string(), fmt % args))

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlsplit(self.path)
            q = urllib.parse.parse_qs(url.query)

            def num(name, default, lo, hi):
                try:
                    v = float(q[name][0])
                except (KeyError, ValueError):
                    return default
                return min(max(v, lo), hi)

            try:
                if url.path == "/":
                    info = svc.info()
                    page = _PAGE.format(scene=info["scene"], it=info["iteration"],
                                        elev=round(svc.rig_elev_deg()))
                    self._send(200, "text/html", page.encode())
                elif url.path == "/info":
                    self._send(200, "application/json", json.dumps(svc.info()).encode())
                elif url.path == "/frame":
                    u8 = svc.render_u8(
                        theta=num("theta", 0.0, 0.0, 360.0),
                        elev=num("elev", 0.0, -80.0, 80.0) if "elev" in q else None,
                        radius=num("radius", 1.0, 0.3, 3.0),
                        scale=num("scale", 0.25, 0.05, 2.0),
                        view=q.get("view", ["rgb"])[0])
                    self._send(200, "image/jpeg", encode_jpeg(u8))
                else:
                    self._send(404, "text/plain", b"not found")
            except BrokenPipeError:
                pass
            except ValueError as exc:  # the client's input (a view, a scale)
                self._send(400, "text/plain", str(exc).encode())
            except Exception as exc:  # a render error, to the client
                self._send(500, "text/plain", repr(exc).encode())

    return Handler


def make_server(svc: Service, host: str = "127.0.0.1", port: int = 8008) -> ThreadingHTTPServer:
    """The HTTP server of ``svc`` (port 0: any free port), not yet serving."""
    return ThreadingHTTPServer((host, port), make_handler(svc))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="tinynerf (PyTorch) render service.")
    parser.add_argument("--conf", type=str, required=True,
                        help="scene name under ./conf/ or a path to an .ini")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--cpu", action="store_true", help="render on the CPU")
    args = parser.parse_args(argv)

    from tinynerf_torch.config import load_config
    from tinynerf_torch.runner import Runner

    cfg = load_config(args.conf)
    cfg.continue_ = True  # serving needs trained weights: resume the latest
    runner = Runner(cfg, device="cpu" if args.cpu else "cuda")
    if runner.last_iter < 0:
        raise SystemExit(f"no checkpoint under {cfg.ckpt_path!r}: refusing to serve "
                         "fresh weights; train first (python -m tinynerf_torch "
                         "--conf=... --mode=train)")
    svc = Service(cfg, runner)
    server = make_server(svc, args.host, args.port)
    print(f"serving {svc.info()['scene']} (iter {runner.last_iter}) on "
          f"http://{args.host}:{server.server_address[1]}/", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
