"""Forge server — the model hub service (the port of
``veles_tpu/forge/server.py``; rebuild of
veles/forge/forge_server.py:462).

Stores uploaded model packages (the package_export tar.gz format)
under ``<store>/<name>/<version>/`` with a metadata.json each; serves
list/versions/fetch/upload over HTTP (stdlib threading server — the
reference used Tornado + a git-backed version store,
forge_server.py:103-455).  Version-history semantics: every version is
retained with uploader/timestamp/sha256 metadata, ``/versions?name=``
returns the ordered history, an existing name+version cannot be
silently overwritten (HTTP 409 — the git store's equivalent of
history immutability), and fetches are checksum-verified end to end."""

import hashlib
import json
import os
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from veles_tpu_torch.logger import Logger

_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


class VersionExists(ValueError):
    """Re-upload of an existing name+version (history is immutable)."""


class ForgeStore:
    """Filesystem package store with retained version history."""

    def __init__(self, directory):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # the HTTP front is threaded: the exists-check + blob/metadata
        # writes must be atomic or two racing uploads of one
        # name+version both pass the immutability check and can pair
        # A's blob with B's checksum
        self._write_lock = threading.Lock()

    def _dir(self, name, version):
        if not _NAME_RE.match(name) or not _NAME_RE.match(version):
            raise ValueError("invalid package name/version")
        return os.path.join(self.directory, name, version)

    def save(self, name, version, blob, metadata):
        d = self._dir(name, version)
        with self._write_lock:
            if os.path.isfile(os.path.join(d, "metadata.json")):
                raise VersionExists(
                    "%s==%s already exists — versions are retained "
                    "history, pick a new version" % (name, version))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "package.tar.gz"), "wb") as f:
                f.write(blob)
            metadata = dict(metadata, name=name, version=version,
                            uploaded=time.time(), size=len(blob),
                            sha256=hashlib.sha256(blob).hexdigest())
            with open(os.path.join(d, "metadata.json"), "w") as f:
                json.dump(metadata, f, indent=1)
        return metadata

    def list(self):
        out = []
        for name in sorted(os.listdir(self.directory)):
            ndir = os.path.join(self.directory, name)
            if not os.path.isdir(ndir):
                continue
            for version in sorted(os.listdir(ndir)):
                meta = os.path.join(ndir, version, "metadata.json")
                if os.path.isfile(meta):
                    with open(meta) as f:
                        out.append(json.load(f))
        return out

    def versions(self, name):
        """Ordered upload history for one package (oldest first)."""
        history = [m for m in self.list() if m["name"] == name]
        if not history:
            raise KeyError(name)
        return sorted(history, key=lambda m: m["uploaded"])

    def fetch(self, name, version=None):
        if version is None:  # latest by upload time
            version = self.versions(name)[-1]["version"]
        d = self._dir(name, version)
        path = os.path.join(d, "package.tar.gz")
        if not os.path.isfile(path):
            raise KeyError("%s==%s" % (name, version))
        with open(path, "rb") as f:
            blob = f.read()
        digest = hashlib.sha256(blob).hexdigest()
        meta_path = os.path.join(d, "metadata.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                stored = json.load(f).get("sha256")
            if stored and stored != digest:
                raise IOError("stored package %s==%s fails its checksum"
                              % (name, version))
        return blob, version, digest


class ForgeServer(Logger):
    """HTTP front (ref handlers: forge_server.py:103-455)."""

    def __init__(self, directory, port=0, host="127.0.0.1"):
        super(ForgeServer, self).__init__()
        self.store = ForgeStore(directory)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, obj, code=200):
                blob = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                q = dict(urllib.parse.parse_qsl(url.query))
                try:
                    if url.path == "/list":
                        self._json(server.store.list())
                    elif url.path == "/versions":
                        self._json(server.store.versions(q["name"]))
                    elif url.path == "/fetch":
                        blob, version, digest = server.store.fetch(
                            q["name"], q.get("version"))
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/gzip")
                        self.send_header("X-Forge-Version", version)
                        self.send_header("X-Forge-Sha256", digest)
                        self.send_header("Content-Length",
                                         str(len(blob)))
                        self.end_headers()
                        self.wfile.write(blob)
                    else:
                        self.send_error(404)
                except KeyError as e:
                    self._json({"error": "not found: %s" % e}, 404)
                except Exception as e:
                    self._json({"error": str(e)[:200]}, 500)

            def do_POST(self):
                url = urllib.parse.urlparse(self.path)
                q = dict(urllib.parse.parse_qsl(url.query))
                if url.path != "/upload":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    blob = self.rfile.read(length)
                    meta = server.store.save(
                        q["name"], q.get("version", "1.0"), blob,
                        {"description": q.get("description", ""),
                         "uploader": q.get("uploader", "")})
                    self._json(meta)
                except VersionExists as e:
                    self._json({"error": str(e)}, 409)
                except Exception as e:
                    self._json({"error": str(e)[:200]}, 400)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self.url = "http://%s:%d" % (host, self.port)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="forge-server")

    def start(self):
        self._thread.start()
        self.info("forge server on %s (store: %s)", self.url,
                  self.store.directory)
        return self

    def stop(self):
        """Stop serving, close the listening socket and join the
        serving thread."""
        if self._thread.is_alive():
            self._server.shutdown()
            self._thread.join(10)
        self._server.server_close()


def main(argv=None):  # pragma: no cover - service entry
    import argparse
    p = argparse.ArgumentParser(prog="veles_tpu_torch.forge.server")
    p.add_argument("--store", default="forge_store")
    p.add_argument("--port", type=int, default=8190)
    args = p.parse_args(argv)
    server = ForgeServer(args.store, port=args.port)
    server.start()
    threading.Event().wait()


if __name__ == "__main__":  # pragma: no cover
    main()
