"""Forge client (the port of ``veles_tpu/forge/client.py``; rebuild of
veles/forge/forge_client.py:91):
``upload`` / ``fetch`` / ``list`` / version history against a forge
server.  CLI: ``python -m veles_tpu_torch.forge list|fetch|upload ...`` —
the reference exposed the same verbs as ``veles forge <verb>``.
Downloads are verified against the server's sha256."""

import getpass
import hashlib
import json
import os
import urllib.parse
import urllib.request


def list_packages(url, timeout=10):
    with urllib.request.urlopen(url.rstrip("/") + "/list",
                                timeout=timeout) as r:
        return json.load(r)


def versions(url, name, timeout=10):
    """Ordered upload history for one package (oldest first)."""
    full = "%s/versions?%s" % (url.rstrip("/"),
                               urllib.parse.urlencode({"name": name}))
    with urllib.request.urlopen(full, timeout=timeout) as r:
        return json.load(r)


def fetch(url, name, dest, version=None, timeout=30):
    """Download a package (checksum-verified); returns (path, version)."""
    q = {"name": name}
    if version:
        q["version"] = version
    full = "%s/fetch?%s" % (url.rstrip("/"), urllib.parse.urlencode(q))
    with urllib.request.urlopen(full, timeout=timeout) as r:
        got_version = r.headers.get("X-Forge-Version", version or "?")
        expect = r.headers.get("X-Forge-Sha256")
        blob = r.read()
    if expect and hashlib.sha256(blob).hexdigest() != expect:
        raise IOError("fetched %s==%s corrupt: sha256 mismatch"
                      % (name, got_version))
    if os.path.isdir(dest):
        dest = os.path.join(dest, "%s-%s.tar.gz" % (name, got_version))
    with open(dest, "wb") as f:
        f.write(blob)
    return dest, got_version


def upload(url, name, version, package_path, description="",
           uploader=None, timeout=30):
    with open(package_path, "rb") as f:
        blob = f.read()
    if uploader is None:
        try:
            uploader = getpass.getuser()
        except Exception:
            uploader = ""
    q = urllib.parse.urlencode({
        "name": name, "version": version, "description": description,
        "uploader": uploader})
    req = urllib.request.Request(
        "%s/upload?%s" % (url.rstrip("/"), q), data=blob,
        headers={"Content-Type": "application/gzip"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="veles_tpu_torch.forge")
    p.add_argument("command", choices=["list", "fetch", "upload"])
    p.add_argument("--server", required=True, help="forge server URL")
    p.add_argument("--name")
    p.add_argument("--version")
    p.add_argument("--versions", action="store_true",
                   help="list: show the full upload history of --name")
    p.add_argument("--package", help="package path (upload)")
    p.add_argument("--dest", default=".", help="output dir (fetch)")
    p.add_argument("--description", default="")
    args = p.parse_args(argv)
    if args.command == "list" and args.versions:
        if not args.name:
            p.error("--versions requires --name")
        for meta in versions(args.server, args.name):
            print("%(name)s %(version)s  %(size)d bytes  "
                  "uploader=%(uploader)s  sha256=%(sha256).12s  "
                  "%(description)s" % dict(
                      {"uploader": "?", "sha256": "?" * 12}, **meta))
    elif args.command == "list":
        for meta in list_packages(args.server):
            print("%(name)s %(version)s  %(size)d bytes  "
                  "%(description)s" % meta)
    elif args.command == "fetch":
        path, version = fetch(args.server, args.name, args.dest,
                              args.version)
        print("fetched %s==%s -> %s" % (args.name, version, path))
    else:
        meta = upload(args.server, args.name, args.version or "1.0",
                      args.package, args.description)
        print("uploaded %(name)s==%(version)s (%(size)d bytes)" % meta)
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys
    sys.exit(main())
