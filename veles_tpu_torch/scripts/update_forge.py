"""update_forge — push every packaged workflow under a tree to a forge
server (the port of ``veles_tpu/scripts/update_forge.py``; rebuild of
veles/scripts/update_forge.py: the reference walked
its sample workflows and uploaded each folder carrying a forge
manifest).

Here the unit of publication is a ``forge.json`` manifest next to a
``package_export`` archive::

    {"name": "mnist-mlp", "version": "1.2",
     "description": "...", "package": "mnist.tar.gz"}

Every manifest found under ``--root`` is uploaded; a version that
already exists on the server is skipped (the store's history is
immutable — HTTP 409).

Usage: ``python -m veles_tpu_torch.scripts.update_forge --server URL
[--root DIR]``  (``FORGE_SERVER`` env is the --server fallback,
like the reference).
"""

import argparse
import json
import logging
import os
import sys
import urllib.error

log = logging.getLogger("update_forge")

MANIFEST = "forge.json"


def find_manifests(root):
    for dirpath, _dirnames, filenames in os.walk(root):
        if MANIFEST in filenames:
            yield os.path.join(dirpath, MANIFEST)


def upload_manifest(server, manifest_path):
    """Upload one manifest's package; returns "uploaded" | "exists" |
    "error"."""
    from veles_tpu_torch.forge.client import upload
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        package = os.path.join(os.path.dirname(manifest_path),
                               manifest["package"])
    except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
        # one broken manifest must not abort the rest of the sweep
        log.error("%s: unreadable manifest: %s", manifest_path, e)
        return "error"
    if not os.path.isfile(package):
        log.error("%s: package %s missing", manifest_path, package)
        return "error"
    try:
        meta = upload(server, manifest["name"],
                      str(manifest.get("version", "1.0")), package,
                      description=manifest.get("description", ""))
        log.info("uploaded %s==%s (%d bytes)", meta["name"],
                 meta["version"], meta["size"])
        return "uploaded"
    except urllib.error.HTTPError as e:
        if e.code == 409:
            log.info("%s==%s already on the server — skipped",
                     manifest["name"], manifest.get("version", "1.0"))
            return "exists"
        log.error("%s: upload failed: %s", manifest_path, e)
        return "error"
    except Exception as e:
        log.error("%s: upload failed: %s", manifest_path, e)
        return "error"


def main(argv=None):
    p = argparse.ArgumentParser(prog="veles_tpu_torch.scripts.update_forge")
    p.add_argument("--server", default=os.getenv("FORGE_SERVER"),
                   help="forge server URL (or FORGE_SERVER env)")
    p.add_argument("--root", default=".",
                   help="tree to scan for %s manifests" % MANIFEST)
    args = p.parse_args(argv)
    if not args.server:
        p.error("no forge server: pass --server or set FORGE_SERVER")
    statuses = [upload_manifest(args.server, m)
                for m in find_manifests(args.root)]
    if not statuses:
        log.warning("no %s manifests under %s", MANIFEST, args.root)
    return 1 if "error" in statuses else 0


if __name__ == "__main__":  # pragma: no cover
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
