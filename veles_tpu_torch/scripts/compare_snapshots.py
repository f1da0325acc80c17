"""compare_snapshots — parameter diff between two workflow snapshots
(the port of ``veles_tpu/scripts/compare_snapshots.py``; rebuild of
veles/scripts/compare_snapshots.py).  Either snapshot may be the
port's or the JAX package's (read through
:mod:`veles_tpu_torch.jax_snapshot`, as ``-s`` reads it).

Usage: ``python -m veles_tpu_torch.scripts.compare_snapshots a.pickle.gz
b.pickle.gz``  — prints per-parameter L2/Linf deltas and a summary
verdict (identical / close / diverged)."""

import argparse
import sys

import numpy


def snapshot_params(path):
    """{layer/param: numpy array} of a snapshot's forward chain; a
    layer is named by its position and class (``0_All2AllTanh``): the
    port's chain units are modules without names."""
    import torch
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    wf = SnapshotterToFile.import_file(path)
    forwards = getattr(wf, "forwards", None)
    if not forwards:
        raise ValueError("%s has no forward chain" % path)
    out = {}
    for i, u in enumerate(forwards):
        for name, t in u.params.items():
            out["%d_%s/%s" % (i, type(u).__name__, name)] = \
                t.detach().to("cpu", torch.float32).numpy()
    return out


def compare(params_a, params_b):
    rows = []
    for key in sorted(set(params_a) | set(params_b)):
        a = params_a.get(key)
        b = params_b.get(key)
        if a is None or b is None:
            rows.append((key, None, None, "only in %s"
                         % ("B" if a is None else "A")))
            continue
        if a.shape != b.shape:
            rows.append((key, None, None,
                         "shape %s vs %s" % (a.shape, b.shape)))
            continue
        diff = a.astype(numpy.float64) - b
        rows.append((key, float(numpy.sqrt((diff ** 2).mean())),
                     float(numpy.abs(diff).max()), ""))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch.scripts.compare_snapshots")
    p.add_argument("snapshot_a")
    p.add_argument("snapshot_b")
    p.add_argument("--atol", type=float, default=1e-6,
                   help="max |delta| treated as identical")
    args = p.parse_args(argv)
    rows = compare(snapshot_params(args.snapshot_a),
                   snapshot_params(args.snapshot_b))
    worst = 0.0
    print("%-32s %12s %12s" % ("parameter", "rmse", "max|delta|"))
    for key, rmse, linf, note in rows:
        if note:
            print("%-32s %s" % (key, note))
            worst = float("inf")
        else:
            print("%-32s %12.3e %12.3e" % (key, rmse, linf))
            worst = max(worst, linf)
    if worst <= args.atol:
        print("VERDICT: identical (within %g)" % args.atol)
        return 0
    print("VERDICT: diverged (max delta %.3e)" % worst)
    return 1


if __name__ == "__main__":
    sys.exit(main())
