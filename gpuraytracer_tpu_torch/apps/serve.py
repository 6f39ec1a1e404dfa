"""Live HTTP preview: the swapchain-present analog for a headless renderer.

Port of gpuraytracer_tpu/apps/serve.py. Serves the latest rendered frame
at http://host:port/ with an auto-refreshing page, while a render thread
keeps rendering animated frames through render/renderer.Renderer (the
PeekMessage/WM_PAINT pump analog). Endpoints:
  /            the page
  /frame.png   the latest frame (503 until the first one)
  /stats       the status line (fps, Mrays/s, device)
  /resize?w=&h=  a new size, 8..7680 x 8..4320 (else 400), applied by the
               render thread between frames (Renderer.resize)

Usage:
  python -m gpuraytracer_tpu_torch.apps.serve --width 640 --height 360 --port 8000

``--device cuda`` (the default) renders on the card and fails without one;
``--device cpu`` renders through the PyTorch wavefront. The render thread
sets its CUDA device itself.
"""

from __future__ import annotations

import argparse
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from gpuraytracer_tpu_torch.utils.log import get_logger

log = get_logger("serve")

MIN_SIZE, MAX_SIZE = (8, 8), (7680, 4320)

_PAGE = b"""<!doctype html>
<html><head><title>gpuraytracer_tpu_torch</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;height:100vh}
img{image-rendering:pixelated;max-width:96vw;max-height:90vh}
p{color:#ccc;font:12px monospace;text-align:center}</style></head>
<body><div><img id="f" src="/frame.png">
<p id="s"></p></div>
<script>
const img=document.getElementById('f');const s=document.getElementById('s');
setInterval(async()=>{const r=await fetch('/stats');s.textContent=await r.text();
img.src='/frame.png?'+Date.now();},500);
</script></body></html>"""


class PreviewState:
    def __init__(self):
        self.lock = threading.Lock()
        self.png_bytes: bytes = b""
        self.frames = 0
        self.status: str = "rendering first frame..."
        # Resize requested over HTTP; applied by the render thread between
        # frames (the WM_SIZE-on-the-message-thread analog).
        self.pending_size = None


def render_loop(state: PreviewState, width: int, height: int, info, stop: threading.Event):
    """Render animated frames on ``info.device`` (parallel/device.DeviceInfo)
    until ``stop`` is set, publishing each as a PNG. A failure is logged and
    shown as the status; the thread ends."""
    try:
        _render_frames(state, width, height, info, stop)
    except Exception as e:  # the thread's boundary: report, keep serving
        log.exception("render thread failed")
        with state.lock:
            state.status = f"render thread failed: {type(e).__name__}: {e}"


def _render_frames(state, width, height, info, stop):
    from gpuraytracer_tpu_torch.render.renderer import Renderer
    from gpuraytracer_tpu_torch.runtime import hostrt
    from gpuraytracer_tpu_torch.utils import png as png_mod
    from gpuraytracer_tpu_torch.utils.stats import FrameStats

    if info.platform == "cuda":
        torch.cuda.set_device(info.device)
    renderer = Renderer(width, height, device=info.device)
    stats = FrameStats(width, height)
    t0 = hostrt.now_seconds()
    while not stop.is_set():
        with state.lock:
            pending, state.pending_size = state.pending_size, None
        if pending:
            # Window.on_size_changed -> Renderer::on_size_changed chain:
            # rebuilds the size-dependent scene constants.
            renderer.resize(*pending)
            stats = FrameStats(*renderer.size)
        img = renderer.render(hostrt.now_seconds() - t0)
        data = png_mod.encode_png(png_mod.image_to_rgba8(img).cpu().numpy())
        snap = stats.frame_rendered()
        with state.lock:
            state.png_bytes = data
            state.frames += 1
            if snap or state.frames == 1:
                state.status = stats.status_line(info.description)


def parse_size(query: str):
    """(w, h) of a resize query, or None unless both are integers within
    MIN_SIZE..MAX_SIZE (an explicit check, not an assert: a huge or
    non-positive size must never reach the render thread)."""
    q = parse_qs(query)
    try:
        w, h = int(q["w"][0]), int(q["h"][0])
    except (KeyError, ValueError):
        return None
    if not (MIN_SIZE[0] <= w <= MAX_SIZE[0] and MIN_SIZE[1] <= h <= MAX_SIZE[1]):
        return None
    return w, h


def make_handler(state: PreviewState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, ctype=None, body=b""):
            self.send_response(code)
            if ctype:
                self.send_header("Content-Type", ctype)
                self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/frame.png":
                with state.lock:
                    data = state.png_bytes
                if data:
                    self._send(200, "image/png", data)
                else:
                    self._send(503)
            elif url.path == "/resize":
                size = parse_size(url.query)
                if size is None:
                    self._send(400)
                    return
                with state.lock:
                    state.pending_size = size
                self._send(200, "text/plain", f"resizing to {size[0]}x{size[1]}".encode())
            elif url.path == "/stats":
                with state.lock:
                    status = state.status
                self._send(200, "text/plain", status.encode())
            else:
                self._send(200, "text/html", _PAGE)

        def log_message(self, *args):
            pass

    return Handler


class PreviewServer:
    """The HTTP server and the render thread; ``port`` 0 takes an
    ephemeral port (``.port`` says which). ``start`` runs both in
    background threads, ``close`` stops both. A device that is absent
    raises here (parallel/device.pick_device)."""

    def __init__(self, width: int, height: int, *, device="cuda", host: str = "0.0.0.0",
                 port: int = 8000):
        from gpuraytracer_tpu_torch.parallel.device import pick_device

        self.info = pick_device(str(device))
        self.state = PreviewState()
        self._stop = threading.Event()
        self._render = threading.Thread(
            target=render_loop, args=(self.state, width, height, self.info, self._stop),
            name="render", daemon=True)
        self.httpd = ThreadingHTTPServer((host, port), make_handler(self.state))
        self._http = threading.Thread(target=self.httpd.serve_forever, name="http", daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "PreviewServer":
        self._render.start()
        self._http.start()
        return self

    def wait(self) -> None:
        """Block while the server runs."""
        self._http.join()

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._render.join(timeout)
        self._http.join(timeout)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    args = p.parse_args(argv)

    server = PreviewServer(args.width, args.height, device=args.device, port=args.port).start()
    log.info("preview at http://localhost:%d (%dx%d)", server.port, args.width, args.height)
    try:
        server.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
