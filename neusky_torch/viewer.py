"""A minimal interactive viewer: an HTTP server that renders the scene on
demand (mirror of ``neusky_tpu/viewer.py``).  Standard library only; PNGs
are encoded by ``utils/viz.py``.

The single-page UI offers an orbit camera (azimuth / elevation / distance)
rendering rgb, albedo, normal, depth or accumulation; a shadow map with sun
azimuth / elevation, threshold and sigmoid-scale controls; the DDF's depth
seen from its sphere, alone or blended over the render; and a click probe:
the clicked pixel is unprojected through the rendered depth to a surface
point, whose sky visibility is drawn as an equirectangular map.

Run:  python -m neusky_torch.viewer --load-dir outputs/run --method neusky-tiny [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from neusky_torch.utils.profiling import span

_PAGE = """<!doctype html><html><head><title>neusky-torch viewer</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;margin:20px}
img{image-rendering:pixelated;border:1px solid #444}
label{display:inline-block;width:130px}
#probe{position:absolute;border:2px solid #fa0;display:none}
#wrap{position:relative;display:inline-block}</style></head><body>
<h2>neusky-torch viewer</h2>
<div id="wrap"><img id="view" width="512" height="512"/>
<img id="probe" width="128" height="64"/></div>
<div>
<p><label>mode</label><select id="mode">
<option>rgb</option><option>albedo</option><option>normal</option>
<option>depth</option><option>accumulation</option><option>shadow_map</option>
<option>ddf_depth</option><option>ddf_overlay</option></select></p>
<p><label>azimuth</label><input id="az" type="range" min="-180" max="180" value="0"/></p>
<p><label>elevation</label><input id="el" type="range" min="-80" max="80" value="20"/></p>
<p><label>distance</label><input id="dist" type="range" min="5" max="30" value="12"/></p>
<p><label>sun azimuth</label><input id="saz" type="range" min="-180" max="180" value="45"/></p>
<p><label>sun elevation</label><input id="sel" type="range" min="0" max="90" value="45"/></p>
<p><label>threshold</label><input id="thr" type="range" min="0" max="200" value="50"/></p>
<p><label>sigmoid scale</label><input id="sig" type="range" min="1" max="500" value="50"/></p>
<p style="color:#888">click the image to open a sky-visibility probe at that
surface point</p>
<button onclick="render()">render</button></div>
<script>
function params(){
  return new URLSearchParams({
    mode: document.getElementById('mode').value,
    az: az.value, el: el.value, dist: (dist.value/10),
    saz: saz.value, sel: sel.value, thr: (thr.value/100), sig: sig.value});
}
function render(){
  document.getElementById('probe').style.display = 'none';
  document.getElementById('view').src = '/render?' + params().toString() + '&t=' + Date.now();
}
document.getElementById('view').addEventListener('click', (e) => {
  const r = e.target.getBoundingClientRect();
  const q = params();
  q.set('px', (e.clientX - r.left) / r.width);
  q.set('py', (e.clientY - r.top) / r.height);
  const probe = document.getElementById('probe');
  probe.style.left = (e.clientX - r.left - 64) + 'px';
  probe.style.top = (e.clientY - r.top - 32) + 'px';
  probe.style.display = 'block';
  probe.src = '/probe?' + q.toString() + '&t=' + Date.now();
});
for (const id of ['mode','az','el','dist','saz','sel','thr','sig'])
  document.getElementById(id).addEventListener('change', render);
render();
</script></body></html>"""

MODES = ("rgb", "albedo", "normal", "depth", "accumulation", "shadow_map", "ddf_depth", "ddf_overlay")


def _q(q, key: str, default) -> float:
    return float(q.get(key, [default])[0])


class ViewerState:
    """The model and params a server renders, one render at a time."""

    def __init__(self, model, params, resolution: int = 96):
        self.model = model
        self.params = params
        self.resolution = resolution
        self.lock = threading.Lock()

    def _camera_rays(self, q):
        """The orbit camera of query ``q`` (degrees ``az``, ``el``; ``dist``)
        looking at the origin → its full-image ray bundle."""
        from neusky_torch.core.cameras import Cameras, CameraType
        from neusky_torch.core.spherical import look_at_target

        with span("viewer.camera_rays"):
            az, el = np.deg2rad(_q(q, "az", 0)), np.deg2rad(_q(q, "el", 20))
            dist = _q(q, "dist", 1.2)
            res = self.resolution
            pos = dist * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
            c2w = look_at_target(pos[None], np.zeros((1, 3)))[..., :3, :]
            cam = Cameras(
                camera_to_worlds=torch.from_numpy(np.ascontiguousarray(c2w)),
                fx=torch.tensor([0.9 * res]), fy=torch.tensor([0.9 * res]),
                cx=torch.tensor([res / 2.0]), cy=torch.tensor([res / 2.0]),
                width=res, height=res, camera_type=int(CameraType.PERSPECTIVE),
            ).to(self.model.device)
            return cam.generate_rays(0)

    def _render(self, rb):
        from neusky_torch.engine.eval_loop import render_camera

        return render_camera(self.model, self.params, rb, 0, chunk_size=self.resolution ** 2)

    def probe(self, q) -> np.ndarray:
        """Click probe: the pixel (``px``, ``py`` in [0, 1]) unprojected
        through the rendered depth to a surface point, and the colormapped
        sky visibility of that point [32, 64, 3]."""
        from neusky_torch.engine.render_features import render_shadow_probe
        from neusky_torch.utils.viz import apply_colormap

        res = self.resolution
        px = min(int(_q(q, "px", 0.5) * res), res - 1)
        py = min(int(_q(q, "py", 0.5) * res), res - 1)
        rb = self._camera_rays(q)
        with self.lock:
            outs = self._render(rb)
            idx = py * res + px
            depth = float(outs["depth"].reshape(-1)[idx])
            origin = rb.origins.reshape(-1, 3)[idx].cpu().numpy()
            direction = rb.directions.reshape(-1, 3)[idx].cpu().numpy()
            vis = render_shadow_probe(self.model, self.params, origin + depth * direction, side_length=64,
                                      threshold=_q(q, "thr", 0.5), sigmoid_scale=_q(q, "sig", 50))
        return apply_colormap(vis)

    def render(self, q) -> np.ndarray:
        """The image of mode ``q["mode"]`` (one of :data:`MODES`) from the
        orbit camera → [res, res, 3] in [0, 1]."""
        from neusky_torch.engine.render_features import render_shadow_map
        from neusky_torch.utils.viz import apply_colormap, apply_depth_colormap

        with span("viewer.frame"):
            mode = q.get("mode", ["rgb"])[0]
            res = self.resolution
            rb = self._camera_rays(q)
            with self.lock:
                if mode == "shadow_map":
                    out = render_shadow_map(self.model, self.params, rb, azimuth_deg=_q(q, "saz", 45),
                                            elevation_deg=_q(q, "sel", 45), threshold=_q(q, "thr", 0.5),
                                            sigmoid_scale=_q(q, "sig", 50))
                    return apply_colormap(out["shadow_map"].reshape(res, res))
                if mode in ("ddf_depth", "ddf_overlay"):
                    r = self.model.config.ddf_radius
                    with torch.inference_mode():
                        o = rb.origins / torch.clamp(torch.linalg.norm(rb.origins, dim=-1, keepdim=True),
                                                     min=1e-6) * r
                        dd = self.model.ddf.apply(self.params["ddf_field"], o,
                                                  rb.directions)["expected_termination_dist"]
                    ddf_img = apply_depth_colormap(dd.cpu().numpy().reshape(res, res, 1), near_plane=0.0,
                                                   far_plane=2 * r)
                    if mode == "ddf_depth":
                        return ddf_img
                    # the DDF's depth blended over the scene render
                    return 0.5 * self._render(rb)["rgb"].reshape(res, res, 3) + 0.5 * np.asarray(ddf_img)
                outs = self._render(rb)
                if mode == "rgb":
                    return outs["rgb"].reshape(res, res, 3)
                if mode == "albedo":
                    return outs["albedo"].reshape(res, res, 3)
                if mode == "normal":
                    return (outs["normal"].reshape(res, res, 3) + 1) / 2
                if mode == "depth":
                    return apply_depth_colormap(outs["depth"].reshape(res, res, 1),
                                                accumulation=outs["accumulation"].reshape(res, res, 1))
                return apply_colormap(outs["accumulation"].reshape(res, res))


def png_response(img: np.ndarray, size) -> bytes:
    """``img`` in [0, 1] → 8-bit PNG bytes, resized to ``size`` (width,
    height) by nearest neighbour."""
    from neusky_torch.utils.viz import encode_png_u8, resize_nearest

    arr = np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8)
    return encode_png_u8(resize_nearest(arr, *size))


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(_PAGE.encode())
                return
            if url.path in ("/render", "/probe"):
                try:
                    q = parse_qs(url.query)
                    img = state.probe(q) if url.path == "/probe" else state.render(q)
                    h, w = img.shape[:2]
                    body = png_response(img, (512, 512) if url.path == "/render" else (2 * w, 2 * h))
                except Exception as e:  # the page shows the error; the server keeps serving
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(f"{type(e).__name__}: {e}".encode())
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(404)
            self.end_headers()

    return Handler


def serve(model, params, port: int = 7007, resolution: int = 96):
    state = ViewerState(model, params, resolution)
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(state))
    print(f"viewer at http://localhost:{port}")
    server.serve_forever()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="neusky_torch.viewer")
    parser.add_argument("--method", default="neusky-tiny")
    parser.add_argument("--load-dir", default=None)
    parser.add_argument("--port", type=int, default=7007)
    parser.add_argument("--resolution", type=int, default=96)
    parser.add_argument("--data", default=None)
    parser.add_argument("--scene", default="site1")
    parser.add_argument("--downscale", type=int, default=1)
    parser.add_argument("--rays-per-batch", type=int, default=1024)
    parser.add_argument("--synthetic-demo", action="store_true", default=True)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from neusky_torch.engine.eval_loop import _load_run

    model, params, _ = _load_run(args, [])
    serve(model, params, args.port, args.resolution)


if __name__ == "__main__":
    main()
