"""Graphics client — the matplotlib process (the port of
``veles_tpu/graphics_client.py``).

Subscribes to the training process's PUB endpoint
(:mod:`veles_tpu_torch.graphics_server`), renders every payload kind
with matplotlib (Agg: one PNG file per plot name) and exits when the
publisher has been idle for ``--timeout`` seconds.  Payloads are read by
the restricted unpickler (:func:`veles_tpu_torch.safe_pickle.
safe_loads`).  matplotlib is imported only here, never by the training
process.

Run:  ``python -m veles_tpu_torch.graphics_client tcp://127.0.0.1:PORT
--out plots/``
"""

import argparse
import gzip
import os
import sys

import numpy

from veles_tpu_torch.safe_pickle import safe_loads


def render_payload(payload, figure=None):
    """payload dict → matplotlib Figure (the renderer of each payload
    kind)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    fig = figure or plt.figure(figsize=(6, 4))
    fig.clf()
    ax = fig.add_subplot(111)
    kind = payload["kind"]
    if kind == "curve":
        for label, ys in payload["series"].items():
            ax.plot(ys, label=label)
        ax.set_xlabel("updates")
        ax.set_ylabel(payload.get("ylabel", "value"))
        ax.legend(loc="best")
    elif kind == "matrix":
        data = numpy.asarray(payload["data"])
        im = ax.imshow(data, interpolation="nearest", cmap="viridis")
        fig.colorbar(im, ax=ax)
        ax.set_xlabel("predicted")
        ax.set_ylabel("target")
    elif kind == "images":
        tiles = numpy.asarray(payload["tiles"])
        n = len(tiles)
        side = int(numpy.ceil(numpy.sqrt(n)))
        fig.clf()
        for i, tile in enumerate(tiles):
            sub = fig.add_subplot(side, side, i + 1)
            sub.imshow(tile, cmap="gray")
            sub.axis("off")
    elif kind == "histogram":
        edges = payload["edges"]
        ax.bar(edges[:-1], payload["counts"],
               width=numpy.diff(edges), align="edge")
    elif kind == "multi_histogram":
        fig.clf()
        layers = payload["layers"]
        for i, (name, h) in enumerate(sorted(layers.items())):
            sub = fig.add_subplot(len(layers), 1, i + 1)
            edges = h["edges"]
            sub.bar(edges[:-1], h["counts"],
                    width=numpy.diff(edges), align="edge")
            sub.set_title(name, fontsize=8)
    elif kind == "table":
        ax.axis("off")
        ax.table(cellText=[[str(c) for c in row]
                           for row in payload["rows"]],
                 colLabels=payload["header"], loc="center")
    else:
        raise ValueError("unknown payload kind %r" % kind)
    fig.suptitle(payload.get("name", kind))
    return fig


def main(argv=None):
    p = argparse.ArgumentParser(prog="veles_tpu_torch.graphics_client")
    p.add_argument("endpoint", help="PUB endpoint, e.g. tcp://host:port")
    p.add_argument("--out", default="plots", help="PNG output directory")
    p.add_argument("--timeout", type=float, default=30.0,
                   help="exit after this many idle seconds")
    p.add_argument("--limit", type=int, default=0,
                   help="exit after N payloads (0 = run until idle)")
    args = p.parse_args(argv)
    import zmq
    ctx = zmq.Context.instance()
    sock = ctx.socket(zmq.SUB)
    sock.setsockopt(zmq.SUBSCRIBE, b"")
    sock.connect(args.endpoint)
    os.makedirs(args.out, exist_ok=True)
    n = 0
    poller = zmq.Poller()
    poller.register(sock, zmq.POLLIN)
    fig = None  # one figure reused across payloads (no pyplot leak)
    while True:
        if not poller.poll(args.timeout * 1000):
            break
        payload = safe_loads(gzip.decompress(sock.recv()))
        fig = render_payload(payload, figure=fig)
        path = os.path.join(
            args.out, "%s.png" % payload.get("name", "plot"))
        fig.savefig(path)
        print("rendered %s -> %s" % (payload["kind"], path), flush=True)
        n += 1
        if args.limit and n >= args.limit:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
