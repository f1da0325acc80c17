"""Snapshotter — periodic whole-workflow checkpointing (the port of
``veles_tpu/snapshotter.py``).

Pickles the live workflow object graph (parameters, solver state, loader
epoch position, RNG states — everything that isn't a volatile ``*_``
attribute) to a compressed file, keeps a ``_current`` symlink, gates on
iteration/wall-clock intervals and on the decision's ``improved`` flag,
and resumes via :meth:`SnapshotterToFile.import_file`.  Every tensor is
pickled as a host copy, so a snapshot written on the card loads on the
CPU; ``initialize(device=)`` puts the workflow back on a device.

Codecs: none / gz / bz2 / xz.  The database backend is
:class:`SnapshotterToDB` on ``sqlite:<path>`` DSNs (the reference's
ODBC DSNs through pyodbc are not ported: the port depends on no ODBC
driver).  The reference's ``root.common.dirs.snapshots``
and ``root.common.snapshot_suffix`` are the ``directory`` (default
``"snapshots"``) and ``suffix`` arguments.  A snapshot file of the JAX
package resumes too: :meth:`SnapshotterToFile.import_file` and
:meth:`SnapshotterToDB.import_db` read it through the restricted
unpickler of :mod:`veles_tpu_torch.jax_snapshot`, which never imports
``jax``.
"""

import bz2
import gzip
import io
import lzma
import os
import pickle
import time

from veles_tpu_torch.units import Unit

CODECS = {
    None: lambda p, m: open(p, m + "b"),
    "": lambda p, m: open(p, m + "b"),
    "gz": lambda p, m: gzip.open(p, m + "b"),
    "bz2": lambda p, m: bz2.open(p, m + "b"),
    "xz": lambda p, m: lzma.open(p, m + "b"),
}

EXT = {None: ".pickle", "": ".pickle", "gz": ".pickle.gz",
       "bz2": ".pickle.bz2", "xz": ".pickle.xz"}


def _forward_units(wf):
    """The workflow's units and its forward chain's units (the port's
    chain units are modules, not workflow units)."""
    seen = []
    for unit in list(getattr(wf, "units", ())) + list(
            getattr(wf, "forwards", None) or ()):
        if all(unit is not s for s in seen):
            seen.append(unit)
    return seen


class _PortUnpickler(pickle.Unpickler):
    """The port's own snapshots: a class of a workflow file the command
    line ran (``mnist.MnistWorkflow``) resolves to the port's sample of
    that name when no module of that name is loaded."""

    def find_class(self, module, name):
        try:
            return super(_PortUnpickler, self).find_class(module, name)
        except ModuleNotFoundError:
            if "." in module:
                raise
            return super(_PortUnpickler, self).find_class(
                "veles_tpu_torch.samples." + module, name)


def _loads(blob):
    """A workflow from snapshot bytes: the JAX package's through
    :mod:`veles_tpu_torch.jax_snapshot`, the port's own as pickled."""
    from veles_tpu_torch import jax_snapshot
    if jax_snapshot.names_jax_package(blob):
        return jax_snapshot.load(blob)
    return _PortUnpickler(io.BytesIO(blob)).load()


class SnapshotterBase(Unit):
    """Common gating logic (ref: snapshotter.py:84-248).

    Fires when its gate opens AND (``decision.improved`` if linked) AND
    the interval/time_interval has elapsed.
    """

    hide_from_registry = True
    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, prefix="wf", interval=1,
                 time_interval=1.0, compression="gz", directory="snapshots",
                 suffix="", **kwargs):
        super(SnapshotterBase, self).__init__(workflow, **kwargs)
        self.prefix = prefix
        self.interval = interval
        self.time_interval = time_interval
        self.compression = compression
        self.directory = directory
        self.decision = None   # optional: gate on .improved
        #: ensemble/genetics instances disambiguate their files by it
        self.suffix = suffix
        self.destination = None
        self._skipped = 0
        self._last_time = 0.0

    def initialize(self, **kwargs):
        super(SnapshotterBase, self).initialize(**kwargs)
        os.makedirs(self.directory, exist_ok=True)
        self._last_time = time.time()

    def run(self):
        if self.decision is not None and not self.decision.improved:
            return
        self._skipped += 1
        if self._skipped < self.interval:
            return
        if time.time() - self._last_time < self.time_interval:
            return
        self._skipped = 0
        self._last_time = time.time()
        self.export()

    def export(self):
        raise NotImplementedError()


class SnapshotterToFile(SnapshotterBase):
    """Pickle to file with codec + ``_current`` symlink
    (ref: snapshotter.py:360-426)."""

    def export(self):
        target = self.workflow
        name = "%s%s%s" % (self.prefix,
                           ("_" + self.suffix) if self.suffix else "",
                           EXT[self.compression])
        path = os.path.join(self.directory, name)
        with self.timed_event("snapshot"):
            try:
                with CODECS[self.compression](path, "w") as f:
                    pickle.dump(target, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:  # any failure class — diagnose, then re-raise
                # name the offending attribute path, not just the
                # innermost type (ref: pickle2.py debug hooks)
                from veles_tpu_torch.pickle_debug import explain_pickle_failure
                explain_pickle_failure(target, logger=self)
                raise
        self.destination = path
        size = os.path.getsize(path)
        self.info("snapshot -> %s (%.1f MiB)", path, size / 2 ** 20)
        current = os.path.join(self.directory,
                               "%s_current%s" % (self.prefix,
                                                 EXT[self.compression]))
        try:
            if os.path.islink(current) or os.path.exists(current):
                os.unlink(current)
            os.symlink(os.path.basename(path), current)
        except OSError:
            pass

    @staticmethod
    def import_file(path, weights_dtype=None):
        """Load a snapshot back into a live workflow, on the host
        (ref: snapshotter.py:411-420 + __main__.py:539-589); its
        ``initialize(device=)`` puts it on a device.

        ``weights_dtype="int8"`` quantizes every forward unit exposing
        ``quantize_weights`` (the transformer blocks) at load time:
        the f32 checkpoint stays on disk untouched, the resident copy
        holds int8 weights + per-output-column scales.  Serving quality
        rides the weight_quant gate
        (serving/kv_quality.weight_quant_quality)."""
        if weights_dtype not in (None, "fp32", "int8"):
            raise ValueError(
                "weights_dtype must be fp32 or int8, got %r"
                % (weights_dtype,))
        for codec, ext in EXT.items():
            if path.endswith(ext) and ext != ".pickle":
                opener = CODECS[codec]
                break
        else:
            opener = CODECS[None]
        with opener(path, "r") as f:
            obj = _loads(f.read())
        obj._restored_from_snapshot_ = True
        if weights_dtype == "int8":
            for unit in _forward_units(obj):
                if hasattr(unit, "quantize_weights"):
                    unit.quantize_weights()
        return obj


class SnapshotterToDB(SnapshotterBase):
    """Database-backed snapshot store (ref: snapshotter.py:428-518 — the
    reference spoke ODBC) on an ``sqlite:<path>`` DSN.  The table name
    is validated as an identifier (it cannot ride a parameter marker in
    DDL)."""

    def __init__(self, workflow, odbc=None, table="veles", **kwargs):
        super(SnapshotterToDB, self).__init__(workflow, **kwargs)
        self.odbc = odbc
        if not table.isidentifier():
            raise ValueError("table %r is not a valid identifier" % table)
        self.table = table

    def init_unpickled(self):
        super(SnapshotterToDB, self).init_unpickled()
        self._conn_ = None

    @staticmethod
    def _connect(dsn):
        if not dsn.startswith("sqlite:"):
            raise ValueError("only sqlite:<path> DSNs are supported, not %r"
                             % (dsn,))
        import sqlite3
        return sqlite3.connect(dsn[len("sqlite:"):])

    def initialize(self, **kwargs):
        super(SnapshotterToDB, self).initialize(**kwargs)
        self._ensure_conn()

    def _ensure_conn(self):
        if self._conn_ is None:
            self._conn_ = self._connect(self.odbc)
            ddl = ("CREATE TABLE IF NOT EXISTS %s (id INTEGER "
                   "PRIMARY KEY, prefix TEXT, ts TIMESTAMP, blob BLOB)")
            cur = self._conn_.cursor()
            cur.execute(ddl % self.table)
            self._conn_.commit()

    def export(self):
        self._ensure_conn()
        blob = self._codec_dump(self.workflow)
        cur = self._conn_.cursor()
        cur.execute(
            "INSERT INTO %s (prefix, ts, blob) VALUES (?, "
            "CURRENT_TIMESTAMP, ?)" % self.table, (self.prefix, blob))
        self._conn_.commit()
        self.destination = "db:%s/%s" % (self.table, self.prefix)
        self.info("snapshot -> %s (%.1f MiB)", self.destination,
                  len(blob) / 2 ** 20)

    _DB_CODECS = {None: lambda b: b, "": lambda b: b,
                  "gz": lambda b: gzip.compress(b, 1),
                  "bz2": lambda b: bz2.compress(b),
                  "xz": lambda b: lzma.compress(b)}

    def _codec_dump(self, obj):
        raw = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            return self._DB_CODECS[self.compression](raw)
        except KeyError:
            raise ValueError("unsupported DB snapshot codec %r"
                             % self.compression)

    @classmethod
    def import_db(cls, dsn, table="veles", prefix=None):
        """Load the newest snapshot (optionally for one prefix) back
        into a live workflow (ref resume path: __main__.py:539-589)."""
        if not table.isidentifier():
            raise ValueError("table %r is not a valid identifier" % table)
        conn = cls._connect(dsn)
        try:
            cur = conn.cursor()
            if prefix is not None:
                cur.execute(
                    "SELECT blob FROM %s WHERE prefix = ? "
                    "ORDER BY id DESC LIMIT 1" % table, (prefix,))
            else:
                cur.execute("SELECT blob FROM %s ORDER BY id DESC "
                            "LIMIT 1" % table)
            row = cur.fetchone()
        finally:
            conn.close()
        if row is None:
            raise KeyError("no snapshot in %s" % table)
        blob = bytes(row[0])
        if blob[:2] == b"\x1f\x8b":
            blob = gzip.decompress(blob)
        elif blob[:3] == b"BZh":
            blob = bz2.decompress(blob)
        elif blob[:6] == b"\xfd7zXZ\x00":
            blob = lzma.decompress(blob)
        obj = _loads(blob)
        try:
            obj._restored_from_snapshot_ = True
        except AttributeError:  # plain payloads (no attr dict)
            pass
        return obj


def Snapshotter(workflow, odbc=None, **kwargs):
    """Facade choosing the backend (ref: snapshotter.py:522)."""
    if odbc:
        return SnapshotterToDB(workflow, odbc=odbc, **kwargs)
    return SnapshotterToFile(workflow, **kwargs)
