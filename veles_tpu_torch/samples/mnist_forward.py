"""MNIST inference usage example — the port of
``veles_tpu/samples/mnist_forward.py`` ("how do I run a trained
model").

    python veles_tpu_torch/samples/mnist_forward.py \\
        snapshots/mnist_current.pickle.gz [n] [--device cpu]

reads a snapshot (the port's, or one the JAX package wrote), runs the
first ``n`` samples of the workflow's own data through its forward
chain on the device and prints each predicted digit with its
confidence.  The second source is an exported package
(``model.tar.gz``, the port's or the JAX package's), run on ``n``
random inputs of its packaged shape::

    python veles_tpu_torch/samples/mnist_forward.py model.tar.gz [n]
"""

import sys

import numpy
import torch


def forward_from_snapshot(path, n=8, device=None):
    """The chain's output (probabilities) for the first ``n`` samples of
    the snapshot's loader data, as a numpy array."""
    from veles_tpu_torch.backends import resolve_device
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    dev = resolve_device(device)
    wf = SnapshotterToFile.import_file(path)
    loader = wf.loader
    loader.load_data()  # datasets are not stored in snapshots
    x = torch.as_tensor(numpy.asarray(loader.original_data[:n],
                                      numpy.float32), device=dev)
    with torch.no_grad():
        for u in wf.forwards:
            u.to_device(dev)
            x = u.apply(x)
    return x.float().cpu().numpy()


def forward_from_package(path, n=8, device=None):
    """The package's output for ``n`` random inputs of its packaged
    sample shape (``default_rng(0)``, as the reference draws them)."""
    from veles_tpu_torch.package_export import load_package
    pkg = load_package(path, device=device)
    rng = numpy.random.default_rng(0)
    x = rng.random((n,) + pkg.input_shape[1:], numpy.float32)
    return numpy.asarray(pkg.run(x))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        print(__doc__)
        return 2
    path = argv[0]
    n = int(argv[1]) if len(argv) > 1 else 8
    if path.endswith((".tar.gz", ".tgz")):
        probs = forward_from_package(path, n, device)
    else:
        probs = forward_from_snapshot(path, n, device)
    for i, row in enumerate(probs):
        digit = int(numpy.argmax(row))
        print("sample %d: digit %d (p=%.3f)" % (i, digit, row[digit]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
