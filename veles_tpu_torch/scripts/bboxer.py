"""bboxer — browser bounding-box labeling tool (the port of
``veles_tpu/scripts/bboxer.py``; rebuild of
veles/scripts/bboxer.py: the reference served an image tree with a
canvas UI and stored box selections server-side).

Stdlib-only web app: walks ``--root`` for images, serves a one-page
canvas editor (click-drag to draw, double-click a box to delete,
arrow keys / buttons to move between images, label text box), and
persists every change to ``--out`` (default ``bboxes.json`` in the
root) as ``{relative/path: [{"x","y","w","h","label"}]}`` — a format
an image loader can consume directly.

Usage: ``python -m veles_tpu_torch.scripts.bboxer --root DIR [--port N]``
"""

import argparse
import json
import os
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

_PAGE = """<!DOCTYPE html>
<html><head><title>bboxer</title><style>
 body { font-family: sans-serif; margin: 1em; }
 #wrap { position: relative; display: inline-block; }
 #img { display: block; max-width: 90vw; max-height: 80vh; }
 #overlay { position: absolute; left: 0; top: 0; cursor: crosshair; }
 .bar { margin: .5em 0; }
 button { margin-right: .5em; }
</style></head><body>
<div class="bar">
 <button id="prev">&#8592; prev</button>
 <button id="next">next &#8594;</button>
 label <input id="label" value="object" size="12">
 <span id="status"></span>
</div>
<div id="wrap"><img id="img"><canvas id="overlay"></canvas></div>
<script>
let images = [], idx = 0, boxes = [], drag = null;
const img = document.getElementById('img'),
      cv = document.getElementById('overlay'),
      ctx = cv.getContext('2d');
function redraw() {
  ctx.clearRect(0, 0, cv.width, cv.height);
  ctx.lineWidth = 2; ctx.strokeStyle = '#e33'; ctx.fillStyle = '#e33';
  ctx.font = '13px sans-serif';
  for (const b of boxes) {
    ctx.strokeRect(b.x * cv.width, b.y * cv.height,
                   b.w * cv.width, b.h * cv.height);
    ctx.fillText(b.label, b.x * cv.width + 3, b.y * cv.height + 14);
  }
  if (drag) ctx.strokeRect(drag.x0, drag.y0,
                           drag.x1 - drag.x0, drag.y1 - drag.y0);
  document.getElementById('status').textContent =
    (images[idx] || '?') + '  (' + (idx + 1) + '/' + images.length +
    ', ' + boxes.length + ' box(es))';
}
async function save() {
  await fetch('/api/boxes?' + new URLSearchParams({path: images[idx]}),
              {method: 'POST', body: JSON.stringify(boxes)});
}
async function show(i) {
  idx = (i + images.length) % images.length;
  img.src = '/image/' + images[idx];
  await img.decode().catch(() => {});
  cv.width = img.clientWidth; cv.height = img.clientHeight;
  boxes = await (await fetch('/api/boxes?' +
    new URLSearchParams({path: images[idx]}))).json();
  redraw();
}
cv.addEventListener('mousedown', e => {
  drag = {x0: e.offsetX, y0: e.offsetY, x1: e.offsetX, y1: e.offsetY};
});
cv.addEventListener('mousemove', e => {
  if (drag) { drag.x1 = e.offsetX; drag.y1 = e.offsetY; redraw(); }
});
cv.addEventListener('mouseup', async e => {
  if (!drag) return;
  const x = Math.min(drag.x0, drag.x1) / cv.width,
        y = Math.min(drag.y0, drag.y1) / cv.height,
        w = Math.abs(drag.x1 - drag.x0) / cv.width,
        h = Math.abs(drag.y1 - drag.y0) / cv.height;
  drag = null;
  if (w > 0.005 && h > 0.005)
    boxes.push({x, y, w, h,
                label: document.getElementById('label').value});
  redraw(); await save();
});
cv.addEventListener('dblclick', async e => {
  const px = e.offsetX / cv.width, py = e.offsetY / cv.height;
  boxes = boxes.filter(b => !(px >= b.x && px <= b.x + b.w &&
                              py >= b.y && py <= b.y + b.h));
  redraw(); await save();
});
document.getElementById('prev').onclick = () => show(idx - 1);
document.getElementById('next').onclick = () => show(idx + 1);
document.addEventListener('keydown', e => {
  if (e.key === 'ArrowLeft') show(idx - 1);
  if (e.key === 'ArrowRight') show(idx + 1);
});
fetch('/api/images').then(r => r.json()).then(l => {
  images = l; if (images.length) show(0); else redraw();
});
</script></body></html>
"""


class BBoxStore:
    """Selections file: {relative image path: [box dicts]}."""

    def __init__(self, path):
        self.path = path
        self._lock = threading.Lock()
        self.data = {}
        if os.path.isfile(path):
            with open(path) as f:
                self.data = json.load(f)

    def get(self, image):
        return self.data.get(image, [])

    def put(self, image, boxes):
        with self._lock:
            if boxes:
                self.data[image] = boxes
            else:
                self.data.pop(image, None)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)


def scan_images(root):
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn.lower().endswith(IMAGE_EXTENSIONS):
                out.append(os.path.relpath(os.path.join(dirpath, fn),
                                           root))
    return sorted(out)


def make_server(root, store, host="127.0.0.1", port=0):
    images = scan_images(root)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _safe_rel(self, rel):
            rel = urllib.parse.unquote(rel)
            full = os.path.realpath(os.path.join(root, rel))
            if not full.startswith(os.path.realpath(root) + os.sep):
                return None, None  # path escape attempt
            return rel, full

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                blob = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
            elif url.path == "/api/images":
                self._json(images)
            elif url.path == "/api/boxes":
                q = dict(urllib.parse.parse_qsl(url.query))
                rel, _ = self._safe_rel(q.get("path", ""))
                self._json(store.get(rel) if rel else [])
            elif url.path.startswith("/image/"):
                rel, full = self._safe_rel(url.path[len("/image/"):])
                if not rel or not os.path.isfile(full):
                    self.send_error(404)
                    return
                with open(full, "rb") as f:
                    blob = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "image/*")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
            else:
                self.send_error(404)

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            if url.path != "/api/boxes":
                self.send_error(404)
                return
            q = dict(urllib.parse.parse_qsl(url.query))
            rel, _ = self._safe_rel(q.get("path", ""))
            if rel is None:
                self.send_error(400)
                return
            length = int(self.headers.get("Content-Length", 0))
            boxes = json.loads(self.rfile.read(length) or b"[]")
            store.put(rel, boxes)
            self._json({"ok": True, "count": len(boxes)})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser(prog="veles_tpu_torch.scripts.bboxer")
    p.add_argument("--root", required=True, help="image tree")
    p.add_argument("--out", help="selections file "
                   "(default: <root>/bboxes.json)")
    p.add_argument("--port", type=int, default=8094)
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args(argv)
    store = BBoxStore(args.out or os.path.join(args.root, "bboxes.json"))
    server = make_server(args.root, store, args.host, args.port)
    print("bboxer on http://%s:%d/ (%d images)"
          % (args.host, server.server_address[1],
             len(scan_images(args.root))))
    server.serve_forever()
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
