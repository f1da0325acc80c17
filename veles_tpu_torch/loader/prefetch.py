"""Asynchronous input pipeline — prefetch and host→device overlap for
streaming loaders (the port of ``veles_tpu/loader/prefetch.py``).

Without it every per-minibatch wave pays ``fill_minibatch()`` (the host
decode), normalization and the host→device upload before the trainer
can launch its step, so a streaming loader (image, text, HDF5,
pickles, sound) trains at ``1/(decode + step)``.  With it, batches
``k+1 .. k+depth`` are decoded and uploaded on two background threads
while step ``k`` runs, and the rate becomes ``1/max(decode, step)``.

Three stages over a rotating pool of host staging buffers:

1. **fill** — a worker thread walks the loader's serving state machine
   ahead of the waves (shadow copies of ``global_offset``,
   ``samples_served`` and the shuffle permutation, shuffled by the
   loader's own generator, so the schedule is the synchronous one bit
   for bit) and runs ``fill_minibatch``, normalization, label mapping
   and tail padding against a stand-in ``self`` whose ``minibatch_*``
   attributes point at a staging set (:func:`_make_stage`): the live
   loader's arrays are never written mid-step;
2. **upload** — a second thread copies each staged batch to the
   device.  On the card the staging buffers are pinned host memory and
   the copies are ``non_blocking`` on a dedicated upload stream; an
   event recorded after them is what the compute stream waits on before
   the step reads the batch.  The uploader waits for its own copies
   only (never for the compute stream), so a staging set is free once
   its record has been replaced.  On the CPU the "upload" is a copy
   into a fresh tensor, so no staging buffer is ever aliased by a
   tensor a step still reads;
3. **pop** — the loader's ``run()`` (main thread) dequeues the next
   ready record and replays it: the scalar walk state, then the arrays
   (installed as they are by ``Array.adopt``), then — last — the
   ``last_minibatch`` / ``epoch_ended`` / ``train_ended`` gate Bools,
   so the decision sees the synchronous path's flag sequence.  On the
   card the compute stream waits for the record's upload event there,
   and each device buffer is marked used on that stream
   (``record_stream``): the caching allocator recycles the memory of a
   batch made on the upload stream only after the steps queued on the
   compute stream before its release have run.

Teardown: ``Loader.stop()`` (fired by ``Workflow.stop``) joins both
threads; a worker's exception travels through the queues and is raised
again on the main thread at the next pop, after the pipeline has
closed.  Both loops also exit when the loader is collected (weakref).
"""

import contextlib
import queue
import threading
import weakref

import numpy
import torch

from veles_tpu_torch.loader.base import INDEX_DTYPE, LABEL_DTYPE, TRAIN, VALID
from veles_tpu_torch.memory import DEV_DIRTY, Array, Watcher

#: how long blocking queue ops wait before re-checking liveness (s)
_TICK = 0.1
#: pop gives up after this long without a batch AND without live
#: workers (a stall with live workers keeps waiting: a slow decode is
#: not an error)
_DEAD_POLL = 0.5


def _prefetch_metrics():
    from veles_tpu_torch.telemetry import metrics
    return (
        metrics.gauge(
            "veles_prefetch_depth",
            "configured prefetch depth (ready-queue capacity) per "
            "loader", ("loader",)),
        metrics.gauge(
            "veles_prefetch_occupancy",
            "ready batches waiting in the prefetch queue at pop time "
            "(0 = the trainer outruns the decode; depth = fully "
            "hidden input latency)", ("loader",)),
        metrics.counter(
            "veles_prefetch_batches_total",
            "minibatches served through the asynchronous input "
            "pipeline", ("loader",)),
    )


def _host_buffer(shape, dtype, pinned):
    """A zeroed numpy buffer; on the card's path a view of pinned host
    memory (returned with the tensor that owns it)."""
    if not pinned:
        return numpy.zeros(shape, dtype), None
    owner = torch.zeros(tuple(shape), dtype=torch.from_numpy(
        numpy.zeros((), dtype)).dtype, pin_memory=True)
    return owner.numpy(), owner


class _BufferSet(object):
    """One rotation slot of the host staging pool: staged Arrays for
    the fill stage to write into, with the loader's minibatch shapes
    and types."""

    __slots__ = ("data", "labels", "indices", "targets", "raw_labels",
                 "pins")

    def __init__(self, loader, pinned):
        self.pins = []

        def staged(shape, dtype):
            mem, owner = _host_buffer(shape, dtype, pinned)
            if owner is not None:
                self.pins.append(owner)
            return Array(mem)

        self.data = staged(loader.minibatch_data.shape,
                           loader.minibatch_data.dtype)
        self.labels = staged(
            loader.minibatch_labels.shape or (loader.max_minibatch_size,),
            loader.minibatch_labels.dtype or LABEL_DTYPE)
        self.indices = Array(numpy.zeros(
            (loader.max_minibatch_size,), INDEX_DTYPE))
        targets = getattr(loader, "minibatch_targets", None)
        self.targets = None
        if isinstance(targets, Array) and bool(targets):
            self.targets = staged(targets.shape, targets.dtype)
        self.raw_labels = [None] * loader.max_minibatch_size


def _make_stage(loader, bufs):
    """Stand-in ``self`` for the subclass fill path (``fill_minibatch``,
    ``_normalize_minibatch``, ``_map_minibatch_labels``, ``_pad_tail``):
    a real instance of the loader's class (``__init__`` bypassed) whose
    ``__dict__`` is a shallow copy of the live unit's, with the
    ``minibatch_*`` attributes re-pointed at a staging set.  Dataset
    storage, the normalizer and the class offsets are shared (reads);
    attribute writes land in the stage's own ``__dict__``."""
    from veles_tpu_torch.mutable import unshadow
    stage = object.__new__(unshadow(type(loader)))
    stage.__dict__.update(loader.__dict__)
    stage.__dict__.pop("_linked_attrs_", None)
    stage.minibatch_data = bufs.data
    stage.minibatch_labels = bufs.labels
    stage.minibatch_indices = bufs.indices
    if bufs.targets is not None:
        stage.minibatch_targets = bufs.targets
    stage.raw_minibatch_labels = bufs.raw_labels
    return stage


class _Record(object):
    """One produced minibatch: staged buffers, their device tensors,
    the upload's event and the post-serve state to replay at pop."""

    __slots__ = ("bufs", "cls", "size", "offset", "global_offset",
                 "samples_served", "epoch_number", "shuffle_limit",
                 "train_ended", "last_minibatch", "epoch_ended",
                 "permutation", "dev_data", "dev_labels",
                 "dev_targets", "data_dev_dirty", "targets_dev_dirty",
                 "event", "error")

    def __init__(self, error=None):
        self.error = error
        self.permutation = None
        self.dev_data = None
        self.dev_labels = None
        self.dev_targets = None
        self.data_dev_dirty = False
        self.targets_dev_dirty = False
        self.event = None


class PrefetchPipeline(object):
    """The asynchronous input pipeline (module docstring), owned by a
    :class:`~veles_tpu_torch.loader.base.Loader` as its volatile
    ``prefetch_`` and created on its first per-minibatch ``run()``."""

    def __init__(self, loader, depth):
        from veles_tpu_torch.backends import resolve_device
        self.depth = max(1, int(depth))
        self.loader_name = loader.name
        self._loader_ref = weakref.ref(loader)
        self._stop = threading.Event()
        self._installed = None

        # shadow walk state: the worker advances these ahead of the
        # waves; the loader's own attributes stay at the last POPPED
        # batch, so a snapshot captures a resumable position
        loader.shuffled_indices.map_read()
        self._indices = numpy.array(loader.shuffled_indices.mem)
        self._offset = int(loader.global_offset)
        self._samples = int(loader.samples_served)
        self._shuffle_limit = loader.shuffle_limit
        self._pending_perm = None

        dev = loader.minibatch_data.device
        self.device = dev if dev is not None else resolve_device()
        cuda = self.device.type == "cuda"
        #: the side stream the uploads run on (the card only)
        self.stream = torch.cuda.Stream(device=self.device) if cuda \
            else None

        self._free = queue.Queue()
        for _ in range(self.depth + 3):
            self._free.put(_BufferSet(loader, pinned=cuda))
        self._filled = queue.Queue(maxsize=1)
        self._ready = queue.Queue(maxsize=self.depth)

        depth_g, occupancy_g, batches_c = _prefetch_metrics()
        depth_g.labels(self.loader_name).set(self.depth)
        self._occupancy_g = occupancy_g.labels(self.loader_name)
        self._batches_c = batches_c.labels(self.loader_name)

        # the names are the port's own: the JAX package's tests look for
        # live "prefetch-" threads of its pipelines
        self._fill_thread = threading.Thread(
            target=self._fill_loop, daemon=True,
            name="torch-prefetch-fill:%s" % self.loader_name)
        self._upload_thread = threading.Thread(
            target=self._upload_loop, daemon=True,
            name="torch-prefetch-upload:%s" % self.loader_name)
        self._fill_thread.start()
        self._upload_thread.start()

    # -- the fill stage (worker thread) ---------------------------------------

    def _shuffle_shadow(self, loader):
        """The epoch-wrap reshuffle of the shadow permutation: the same
        generator and call order as ``Loader.shuffle()``."""
        if loader.class_lengths[TRAIN] == 0:
            return
        if self._shuffle_limit is not None:
            if self._shuffle_limit <= 0:
                return
            self._shuffle_limit -= 1
        loader.prng.shuffle(
            self._indices[loader.class_end_offsets[VALID]:])
        # pop installs this copy into loader.shuffled_indices at the
        # first batch of the new epoch, when the synchronous path's
        # shuffle would have become visible
        self._pending_perm = numpy.array(self._indices)

    def _produce_into(self, loader, bufs):
        total = loader.effective_total_samples
        if self._offset >= total:
            self._offset = 0
            self._shuffle_shadow(loader)
        cls, remainder = loader._class_by_offset(self._offset)
        size = min(remainder, loader.max_minibatch_size)
        self._offset += size
        offset = self._offset
        self._samples += size

        rec = _Record()
        rec.bufs = bufs
        rec.cls = cls
        rec.size = size
        rec.offset = offset
        rec.global_offset = self._offset
        rec.samples_served = self._samples
        rec.epoch_number = self._samples // total if total else 0
        rec.shuffle_limit = self._shuffle_limit
        rec.train_ended = self._offset >= total
        rec.last_minibatch, rec.epoch_ended = \
            loader._epoch_flag_values(cls, self._offset)
        rec.permutation, self._pending_perm = self._pending_perm, None

        stage = _make_stage(loader, bufs)
        stage.minibatch_offset = offset
        stage.minibatch_size = size
        stage.minibatch_class = cls
        bufs.indices.mem[:size] = self._indices[offset - size:offset]
        stage.fill_minibatch()
        stage._normalize_minibatch()
        stage._map_minibatch_labels()
        if size < loader.max_minibatch_size:
            stage._pad_tail(size)
        return rec

    def _fill_loop(self):
        while not self._stop.is_set():
            bufs = self._q_get(self._free)
            if bufs is None:
                break
            loader = self._loader_ref()
            if loader is None:
                break
            try:
                rec = self._produce_into(loader, bufs)
            except BaseException as e:  # noqa: B036 — forwarded to pop
                del loader
                self._q_put(self._filled, _Record(error=e))
                break
            del loader
            if not self._q_put(self._filled, rec):
                break

    # -- the upload stage (uploader thread) -----------------------------------

    def _put_copy(self, mem, pins):
        """Host staging buffer → an independent device tensor.  On the
        card: a ``non_blocking`` copy from pinned memory on the upload
        stream (the caller records the event after it); on the CPU: a
        copy, as ``Array``'s synchronous upload makes."""
        if self.stream is None:
            return torch.from_numpy(numpy.array(mem))
        src = next((p for p in pins
                    if p.data_ptr() == mem.ctypes.data
                    and tuple(p.shape) == mem.shape), None)
        if src is None:  # a fill path that replaced the staging buffer
            src = torch.from_numpy(numpy.array(mem))
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        out.copy_(src, non_blocking=True)
        return out

    def _take_devmem(self, arr):
        """A device tensor a device-side fill already produced (the
        FullBatchLoader's gather), taken over as it is; else None."""
        if arr._devmem_ is not None and arr._state == DEV_DIRTY:
            t, arr._devmem_ = arr._devmem_, None
            Watcher.free(t.device, t.numel() * t.element_size())
            return t
        return None

    def _upload_rec(self, rec):
        bufs = rec.bufs
        with torch.cuda.stream(self.stream) if self.stream is not None \
                else contextlib.nullcontext():
            rec.dev_data = self._take_devmem(bufs.data)
            rec.data_dev_dirty = rec.dev_data is not None
            if rec.dev_data is None:
                rec.dev_data = self._put_copy(bufs.data.mem, bufs.pins)
            rec.dev_labels = self._put_copy(bufs.labels.mem, bufs.pins)
            if bufs.targets is not None:
                rec.dev_targets = self._take_devmem(bufs.targets)
                rec.targets_dev_dirty = rec.dev_targets is not None
                if rec.dev_targets is None:
                    rec.dev_targets = self._put_copy(bufs.targets.mem,
                                                     bufs.pins)
            if self.stream is not None:
                rec.event = torch.cuda.Event()
                rec.event.record(self.stream)
        if rec.event is not None:
            # wait for this thread's own copies only: the staging set
            # may be refilled once its record is replaced at pop
            rec.event.synchronize()

    def _upload_loop(self):
        while not self._stop.is_set():
            rec = self._q_get(self._filled)
            if rec is None:
                break
            if rec.error is None:
                try:
                    self._upload_rec(rec)
                except BaseException as e:  # noqa: B036
                    rec = _Record(error=e)
            if not self._q_put(self._ready, rec):
                break
            if rec.error is not None:
                break

    # -- the pop stage (main thread, Loader.run) ------------------------------

    def pop_into(self, loader):
        """Dequeue the next ready batch and replay it onto the live
        loader: scalar walk state, arrays, then the gate Bools — the
        observable sequence of one synchronous serve."""
        self._occupancy_g.set(self._ready.qsize())
        while True:
            try:
                rec = self._ready.get(timeout=_DEAD_POLL)
                break
            except queue.Empty:
                if self._stop.is_set() or not (
                        self._fill_thread.is_alive()
                        and self._upload_thread.is_alive()):
                    self.close()
                    raise RuntimeError(
                        "prefetch pipeline for %s died without "
                        "delivering a batch" % self.loader_name)
        if rec.error is not None:
            # tear down before raising again: no worker is left behind
            self.close()
            raise rec.error
        if self._installed is not None:
            self._free.put(self._installed.bufs)
        self._installed = rec

        if rec.event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(rec.event)
            for t in (rec.dev_data, rec.dev_labels, rec.dev_targets):
                if t is not None:
                    t.record_stream(compute)

        loader.minibatch_class = rec.cls
        loader.minibatch_offset = rec.offset
        loader.minibatch_size = rec.size
        loader.global_offset = rec.global_offset
        loader.samples_served = rec.samples_served
        if not loader.is_slave:
            loader.epoch_number = rec.epoch_number
        loader.shuffle_limit = rec.shuffle_limit
        if rec.permutation is not None:
            loader.shuffled_indices.mem = rec.permutation

        loader.minibatch_data.adopt(
            rec.bufs.data.mem, rec.dev_data, dev_dirty=rec.data_dev_dirty)
        loader.minibatch_labels.adopt(rec.bufs.labels.mem, rec.dev_labels)
        loader.minibatch_indices.adopt(rec.bufs.indices.mem)
        if rec.bufs.targets is not None:
            loader.minibatch_targets.adopt(
                rec.bufs.targets.mem, rec.dev_targets,
                dev_dirty=rec.targets_dev_dirty)
        loader.raw_minibatch_labels = rec.bufs.raw_labels

        # flags LAST: successors (the decision) read them after this wave
        loader.train_ended.set(rec.train_ended)
        loader.last_minibatch.set(rec.last_minibatch)
        loader.epoch_ended.set(rec.epoch_ended)
        self._batches_c.inc()

    # -- liveness-aware queue helpers -----------------------------------------

    def _q_get(self, q):
        while not self._stop.is_set():
            try:
                return q.get(timeout=_TICK)
            except queue.Empty:
                if self._loader_ref() is None:
                    self._stop.set()
        return None

    def _q_put(self, q, item):
        while not self._stop.is_set():
            try:
                q.put(item, timeout=_TICK)
                return True
            except queue.Full:
                if self._loader_ref() is None:
                    self._stop.set()
        return False

    # -- teardown -------------------------------------------------------------

    @property
    def alive(self):
        return self._fill_thread.is_alive() \
            or self._upload_thread.is_alive()

    def close(self, timeout=5.0):
        """Stop both workers and join them (idempotent).  Queue ops poll
        the stop event every _TICK, so a blocked put/get exits within
        one tick; a worker inside a slow ``fill_minibatch`` finishes
        that batch first."""
        self._stop.set()
        for t in (self._fill_thread, self._upload_thread):
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout)
        self._occupancy_g.set(0)

