"""A minimal interactive splat viewer (port of
gscodec_studio_tpu/utils/viewer.py): an HTTP server that renders a frame a
request from orbit parameters (theta, phi, radius and a pan offset) that
an inline HTML page drives by mouse drag and wheel. It renders through any
callback: static splats, a dynamic model at a time, a Runner's
render_view.

    from gscodec_studio_tpu_torch.utils.viewer import SplatViewer
    SplatViewer(lambda c2w, K, w, h: runner.render_view(c2w, K, w, h)
                ).serve(port=8080)  # blocking; or start() / stop()

A frame is a JPEG through imageio where imageio imports, else a PNG
through compression/png_io.py; the response's Content-Type matches, and
its X-Encoder header names the encoder.
"""

from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gscodec_studio_tpu_torch.compression.png_io import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>gscodec viewer</title><style>
body{margin:0;background:#111;color:#ccc;font-family:monospace}
#hud{position:fixed;top:8px;left:8px}
img{display:block;margin:0 auto;image-rendering:auto}
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
<img id="view" width="WIDTH" height="HEIGHT"/>
<script>
let theta=0.6, phi=0.4, radius=RADIUS, cx=0, cy=0, cz=0, busy=false, dirty=true;
const img=document.getElementById('view');
function refresh(){
  if(busy){dirty=true;return;}
  busy=true; dirty=false;
  img.src='/render?theta='+theta+'&phi='+phi+'&radius='+radius+
          '&cx='+cx+'&cy='+cy+'&cz='+cz+'&t='+Date.now();
}
img.onload=()=>{busy=false; if(dirty) refresh();};
img.onerror=()=>{busy=false;};
let drag=null;
window.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY,e.shiftKey];});
window.addEventListener('mouseup',()=>{drag=null;});
window.addEventListener('mousemove',e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){cx+=dx*radius*-0.002; cy+=dy*radius*0.002;}
  else {theta+=dx*0.01; phi=Math.max(-1.5,Math.min(1.5,phi+dy*0.01));}
  drag=[e.clientX,e.clientY,drag[2]]; refresh();
});
window.addEventListener('wheel',e=>{radius*=Math.exp(e.deltaY*0.001);refresh();});
refresh();
</script></body></html>"""


def _orbit_c2w(theta, phi, radius, center) -> np.ndarray:
    """The camera-to-world [4, 4] of an eye on the orbit sphere looking at
    ``center``."""
    eye = center + radius * np.array(
        [np.cos(phi) * np.cos(theta), np.sin(phi),
         np.cos(phi) * np.sin(theta)], np.float32)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0, -1, 0], np.float32))
    n = np.linalg.norm(right)
    right = right / (n if n > 1e-6 else 1.0)
    up = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, eye
    return c2w


def encode_frame(img8: np.ndarray) -> Tuple[bytes, str, str]:
    """(bytes, Content-Type, encoder) of a uint8 [H, W, 3] frame: a JPEG
    through imageio where it imports, else a PNG through png_io."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        return encode_png(img8), "image/png", "png_io"
    buf = io.BytesIO()
    imageio.imwrite(buf, img8, format="jpeg")
    return buf.getvalue(), "image/jpeg", "imageio"


class SplatViewer:
    """render_fn(c2w [4, 4], K [3, 3], width, height) -> [H, W, 3] in
    [0, 1] (an array or a tensor)."""

    def __init__(self, render_fn: Callable, width: int = 640,
                 height: int = 480, focal: Optional[float] = None,
                 center=(0.0, 0.0, 0.0), radius: float = 4.0):
        self.render_fn = render_fn
        self.width, self.height = width, height
        self.focal = focal or 0.9 * width
        self.center = np.asarray(center, np.float32)
        self.radius = radius
        self._server: Optional[ThreadingHTTPServer] = None

    def camera(self, q) -> Tuple[np.ndarray, np.ndarray]:
        """(c2w, K) of a request's query ``q`` (parse_qs)."""
        def g(k, d):
            return float(q.get(k, [d])[0])

        c2w = _orbit_c2w(
            g("theta", 0.6), g("phi", 0.4), g("radius", self.radius),
            self.center + np.array([g("cx", 0), g("cy", 0), g("cz", 0)],
                                   np.float32))
        K = np.array([[self.focal, 0, self.width / 2],
                      [0, self.focal, self.height / 2], [0, 0, 1]],
                     np.float32)
        return c2w, K

    def _render_frame(self, q) -> Tuple[bytes, str, str]:
        c2w, K = self.camera(q)
        img = self.render_fn(c2w, K, self.width, self.height)
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        img8 = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
        return encode_frame(img8)

    def _handler(self):
        viewer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body, extra=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/render":
                    try:
                        data, ctype, enc = viewer._render_frame(
                            parse_qs(u.query))
                    except Exception as e:  # the render's error, to HTTP
                        self._send(500, "text/plain", str(e).encode())
                        return
                    self._send(200, ctype, data, [("X-Encoder", enc)])
                else:
                    page = (_PAGE.replace("WIDTH", str(viewer.width))
                            .replace("HEIGHT", str(viewer.height))
                            .replace("RADIUS", str(viewer.radius)))
                    self._send(200, "text/html", page.encode())

        return H

    def start(self, port: int = 8080, host: str = "0.0.0.0") -> int:
        """Serves in a background thread; returns the port (0 picks a free
        one)."""
        self._server = ThreadingHTTPServer((host, port), self._handler())
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def serve(self, port: int = 8080, host: str = "0.0.0.0"):
        print(f"viewer at http://localhost:{port}/", flush=True)
        self.start(port, host)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            self.stop()
