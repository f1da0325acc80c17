"""Restricted unpickling for network frames and snapshot files (the
port's own copy of ``veles_tpu/safe_pickle.py``).

The ZeroMQ surfaces (streaming ingest, avatar bridging, the plot
PUB/SUB channel) carry pickled *data* — numpy arrays, scalars and
plain containers — but ``pickle.loads`` on a network frame is an
arbitrary-code-execution primitive the moment an endpoint is widened
beyond loopback.
``safe_loads`` replaces it on every receive path: only the allowlisted
constructors below can appear in a frame, anything else raises
``pickle.UnpicklingError``.

``warn_if_public`` adds the loud log line when a socket is
bound/connected beyond localhost — the codec stops code execution, but
an open ingest port is still a data-injection surface the operator
should know about.

:func:`veles_tpu_torch.snapshotter.SnapshotterToFile.import_file` reads
a snapshot file of the JAX package through a subclass of
:class:`RestrictedUnpickler` that maps the JAX package's classes onto
the port's.
"""

import io
import pickle

#: module -> allowed attribute names.  Everything needed to rebuild
#: numpy arrays/scalars/dtypes plus harmless builtin containers —
#: nothing that can execute code on construction.
_ALLOWED = {
    "builtins": {
        "list", "dict", "tuple", "set", "frozenset", "bytearray",
        "complex", "slice", "range", "bool", "int", "float", "str",
        "bytes", "NoneType",
    },
    "collections": {"OrderedDict", "deque", "defaultdict", "Counter"},
    "numpy": {"ndarray", "dtype", "matrix"},
    # bf16-typed host mirrors (the bf16 trunk policy) pickle a
    # reference to the ml_dtypes scalar type — data-only constructors
    "ml_dtypes": {"bfloat16", "float8_e4m3fn", "float8_e5m2"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},  # numpy >= 2
    "numpy.core.numeric": {"_frombuffer"},
    "numpy._core.numeric": {"_frombuffer"},
    "_codecs": {"encode"},  # numpy pickles route text through this
}


class RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name in _ALLOWED.get(module, ()):
            return super(RestrictedUnpickler, self).find_class(
                module, name)
        raise pickle.UnpicklingError(
            "network frame references %s.%s — not in the data-only "
            "allowlist (veles_tpu_torch/safe_pickle.py)" % (module, name))


def safe_loads(blob):
    """``pickle.loads`` restricted to plain data constructors."""
    return RestrictedUnpickler(io.BytesIO(blob)).load()


def warn_if_public(endpoint, logger):
    """Loud warning when a ZMQ endpoint reaches beyond loopback."""
    ep = str(endpoint)
    local = any(h in ep for h in
                ("127.0.0.1", "localhost", "ipc://", "inproc://", "::1"))
    if not local:
        logger.warning(
            "endpoint %s is reachable beyond loopback — frames are "
            "decoded with a restricted unpickler (no code execution), "
            "but anyone who can reach the socket can inject data",
            endpoint)
