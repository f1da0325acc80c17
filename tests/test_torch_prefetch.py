"""The asynchronous input pipeline of the PyTorch port
(``veles_tpu_torch/loader/prefetch.py`` and its hooks in
``loader/base.py``) on the CPU (oracle ``tests/test_prefetch.py``):

- prefetch on equals the synchronous path bit for bit: trained weights,
  the flag sequence the decision sees over several shuffled epochs
  (tail minibatches included), and the served indices across
  reshuffles — and both equal the JAX package's schedule for the same
  seed, its trained weights within 2e-5;
- the fallbacks are the reference's: depth 0, refiled minibatches, a
  loader that opts out (``InteractiveLoader``), a loader outside
  standalone mode, ``torch.distributed`` with a world size above 1;
  span serving bypasses the pipeline;
- a worker's exception is raised again at the next pop with both
  threads gone; ``stop()`` joins both threads;
- the overlap, shown by the order of events (batches decoded while the
  main thread holds its step) and by the occupancy gauge — no
  wall-clock gate;
- the gauges and the input-wait histogram, by mode.
"""

import threading
import time

import numpy
import pytest
import torch

from tests.test_torch_workflow import jax_state

pytestmark = pytest.mark.torch_port

#: how long a liveness wait may take before the test fails (never a
#: performance bound: every wait ends as soon as its event happens)
LIVENESS_S = 60.0


def _stream_class():
    from veles_tpu_torch.loader.base import Loader

    class StreamLoader(Loader):
        """A streaming loader: every minibatch goes through
        fill_minibatch on the host (as the image/text/HDF5 loaders)."""

        def __init__(self, workflow=None, n_valid=20, n_train=70,
                     features=8, classes=3, fail_after=None, gate=None,
                     **kwargs):
            super(StreamLoader, self).__init__(workflow, **kwargs)
            self.sizes = (0, n_valid, n_train)
            self.features = features
            self.classes = classes
            self.fail_after = fail_after
            #: a mutable box: the prefetch worker fills through a stage
            #: whose attribute writes stay local
            self.fill_counter = [0]
            #: optional threading.Semaphore each fill takes first
            self.gate = gate

        def load_data(self):
            total = sum(self.sizes)
            self.class_lengths[:] = list(self.sizes)
            rng = numpy.random.default_rng(0)
            self._base = rng.normal(
                size=(total, self.features)).astype(numpy.float32)
            self._base[:, 0] = numpy.arange(total)
            # a row's identity in [0, 1): unscaled, it would amplify the
            # packages' rounding apart over the epochs
            self._base[:, 0] /= total
            self._lab = (numpy.arange(total) % self.classes).astype(
                numpy.int32)

        def create_minibatch_data(self):
            self.minibatch_data.reset(numpy.zeros(
                (self.max_minibatch_size, self.features), numpy.float32))

        def fill_minibatch(self):
            if self.gate is not None:
                assert self.gate.acquire(timeout=LIVENESS_S)
            self.fill_counter[0] += 1
            if self.fail_after is not None \
                    and self.fill_counter[0] > self.fail_after:
                raise RuntimeError("injected decode failure")
            idx = self.minibatch_indices.mem[:self.minibatch_size]
            self.minibatch_data.mem[:self.minibatch_size] = self._base[idx]
            self.minibatch_labels.mem[:self.minibatch_size] = \
                self._lab[idx]

    return StreamLoader


def _prefetch_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("torch-prefetch-")]


def _wait_no_threads():
    deadline = time.monotonic() + LIVENESS_S
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _prefetch_threads()


def _wave_state(l):
    return (l.minibatch_class, l.minibatch_size, l.minibatch_offset,
            l.epoch_number, bool(l.last_minibatch), bool(l.epoch_ended),
            bool(l.train_ended),
            tuple(int(i) for i in l.minibatch_indices.mem[
                :l.minibatch_size]))


def _train(prefetch, epochs=3):
    """A StandardWorkflow (an MLP) over the streaming loader; returns
    the per-wave state the decision saw and the final weights."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    wf = StandardWorkflow(
        loader_factory=_stream_class(),
        loader_config={"minibatch_size": 32, "prefetch": prefetch,
                       "seed": 7},
        layers=[{"type": "all2all_tanh", "output_sample_shape": (16,)},
                {"type": "softmax", "output_sample_shape": (3,)}],
        solver="sgd", learning_rate=0.1, gradient_moment=0.9,
        decision_config={"max_epochs": epochs},
        snapshotter_config={"enabled": False}, dtype="float32")
    wf.initialize(device="cpu")
    seq = []
    run = wf.decision.run

    def record():
        seq.append(_wave_state(wf.loader))
        run()
    wf.decision.run = record
    wf.run()
    pipeline = wf.loader.prefetch_
    wf.stop()
    from veles_tpu_torch.convert import params_to_numpy
    return seq, params_to_numpy(wf.gd.forwards), pipeline, wf


def test_prefetch_bit_equal_to_sync():
    """Depth 3 against depth 0 over 3 shuffled epochs (70 train / 20
    valid at 32: tail minibatches): the same waves, bit-equal weights."""
    seq_off, w_off, pipe_off, _ = _train(0)
    seq_on, w_on, pipe_on, wf = _train(3)
    assert pipe_off is False and pipe_on is not None
    assert not pipe_on.alive
    assert len(seq_off) > 6 and seq_off == seq_on
    for i in w_off:
        for n in w_off[i]:
            numpy.testing.assert_array_equal(w_on[i][n], w_off[i][n])
    _wait_no_threads()


def _jax_train(prefetch, epochs=3):
    from tests.test_prefetch import StreamLoader
    from veles_tpu.models.standard import StandardWorkflow

    class JStream(StreamLoader):
        """The oracle's streaming loader with the port's row scaling."""

        def load_data(self):
            super(JStream, self).load_data()
            self._base[:, 0] /= sum(self.sizes)

    with jax_state():
        from veles_tpu import prng
        prng.get("loader").seed(7)
        wf = StandardWorkflow(
            None, loader_factory=JStream,
            loader_config={"minibatch_size": 32, "prefetch": prefetch},
            layers=[{"type": "all2all_tanh",
                     "output_sample_shape": (16,)},
                    {"type": "softmax", "output_sample_shape": (3,)}],
            solver="sgd", learning_rate=0.1, gradient_moment=0.9,
            decision_config={"max_epochs": epochs},
            snapshotter_config={"time_interval": 1e9}, plotters=False)
        from tests.test_torch_workflow import _jax_device, _jax_params
        wf.initialize(device=_jax_device())
        seq = []
        run = wf.decision.run

        def record():
            seq.append(_wave_state(wf.loader))
            run()
        wf.decision.run = record
        params = _jax_params(wf.forwards)
        wf.run()
        wf.stop()
        return seq, params, _jax_params(wf.forwards)


def test_prefetch_matches_jax_schedule_and_weights():
    """The port's prefetch arm against the JAX package's (its prefetch
    pipeline on, the same loader seed): the same waves — classes,
    sizes, offsets, flags and served indices — and, from the JAX
    weights, final weights within 2e-5."""
    from veles_tpu_torch.convert import load_workflow_params
    jseq, jinit, jfinal = _jax_train(3)
    from veles_tpu_torch.models.standard import StandardWorkflow
    wf = StandardWorkflow(
        loader_factory=_stream_class(),
        loader_config={"minibatch_size": 32, "prefetch": 3, "seed": 7},
        layers=[{"type": "all2all_tanh", "output_sample_shape": (16,)},
                {"type": "softmax", "output_sample_shape": (3,)}],
        solver="sgd", learning_rate=0.1, gradient_moment=0.9,
        decision_config={"max_epochs": 3},
        snapshotter_config={"enabled": False}, dtype="float32")
    wf.initialize(device="cpu")
    load_workflow_params(wf, jinit)
    seq = []
    run = wf.decision.run

    def record():
        seq.append(_wave_state(wf.loader))
        run()
    wf.decision.run = record
    wf.run()
    wf.stop()
    assert seq == jseq
    from veles_tpu_torch.convert import params_to_numpy
    got = params_to_numpy(wf.gd.forwards)
    for i in jfinal:
        for n in jfinal[i]:
            numpy.testing.assert_allclose(got[i][n], jfinal[i][n],
                                          rtol=2e-5, atol=2e-5)


def _loader(**kw):
    l = _stream_class()(None, minibatch_size=32, **kw)
    l.initialize(device="cpu")
    return l


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_shuffle_parity_across_epochs(depth):
    """Served train indices across reshuffle boundaries equal the
    synchronous run's (the shadow shuffle replays at each epoch's first
    batch); the loader's ``shuffled_indices`` follow too."""

    def run(prefetch, epochs=3):
        l = _loader(prefetch=prefetch, seed=11)
        out = []
        for _ in range(200):
            l.run()
            out.append(_wave_state(l) + (
                tuple(l.shuffled_indices.mem.tolist()),))
            if l.train_ended and l.epoch_number >= epochs:
                break
        l.stop()
        return out

    assert run(0) == run(depth)


def test_fallbacks_are_the_reference_ones(monkeypatch):
    """Depth 0, refiled minibatches, an opted-out loader, a loader
    outside standalone mode and a multi-process job take the
    synchronous path; span serving never creates a pipeline."""
    l = _loader(prefetch=0)
    l.run()
    assert l.prefetch_ is False
    l = _loader(prefetch=2)
    l.failed_minibatches.append((32, 32))
    l.run()
    assert l.prefetch_ is False
    cls = _stream_class()
    monkeypatch.setattr(cls, "prefetchable", False)
    l = cls(None, minibatch_size=32, prefetch=2)
    l.initialize(device="cpu")
    l.run()
    assert l.prefetch_ is False
    monkeypatch.setattr(cls, "prefetchable", True)
    monkeypatch.setattr(cls, "is_standalone", property(lambda s: False))
    l = cls(None, minibatch_size=32, prefetch=2)
    l.initialize(device="cpu")
    l.run()
    assert l.prefetch_ is False
    monkeypatch.undo()
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    l = _loader(prefetch=2)
    l.run()
    assert l.prefetch_ is False
    monkeypatch.undo()
    l = _loader(prefetch=False)
    l.run()
    assert l.prefetch_ is False
    from veles_tpu_torch.loader.interactive import InteractiveLoader
    assert InteractiveLoader.prefetchable is False
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    fb = FullBatchLoader(numpy.zeros((40, 3), numpy.float32),
                         numpy.zeros(40, numpy.int32), [0, 8, 32],
                         minibatch_size=16, device="cpu")
    fb.span_serving = True
    fb.run()
    assert fb.span_fresh_ and fb.prefetch_ is None
    assert not _prefetch_threads()
    l = _loader()
    l.run()
    assert l.prefetch_ not in (None, False) and l.prefetch_.depth == 2
    l.stop()
    _wait_no_threads()


def test_worker_exception_raised_at_next_pop():
    """A decode failure in the worker is raised again on the main
    thread at the next pop, after both workers are gone."""
    l = _loader(prefetch=2, fail_after=4)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        for _ in range(20):
            l.run()
    assert l.fill_counter[0] == 5
    _wait_no_threads()
    l.stop()   # idempotent after the eager close


def test_stop_joins_both_threads():
    """``Workflow.stop`` → ``Loader.stop`` joins the fill and upload
    threads, even while the fill waits on its decode."""
    from veles_tpu_torch.workflow import Workflow
    wf = Workflow(None, name="halt")
    gate = threading.Semaphore(0)
    l = _stream_class()(wf, minibatch_size=32, prefetch=3, gate=gate)
    l.initialize(device="cpu")
    gate.release(3)
    for _ in range(3):
        l.run()
    pipe = l.prefetch_
    assert pipe.alive and len(_prefetch_threads()) == 2
    gate.release(1)
    wf.stop()
    assert l.prefetch_ is None
    gate.release(10)   # let a fill blocked on its decode finish
    _wait_no_threads()
    assert not pipe.alive


def test_overlap_by_order_of_events():
    """While the main thread holds its 'step' after popping batch k, the
    workers decode and upload batches k+1..k+depth: the ready queue
    fills to its depth with no run() called, and the next pop reads
    that occupancy.  The synchronous path decodes only inside run()."""
    from veles_tpu_torch import telemetry
    depth = 3
    l = _loader(prefetch=depth, n_valid=0, n_train=320,
                name="overlap-port")
    occupancy = telemetry.metrics.gauge(
        "veles_prefetch_occupancy", labelnames=("loader",)).labels(
        "overlap-port")
    for k in range(8):
        l.run()
        if k:
            assert occupancy.value == depth
        # the "step": it ends once the workers have filled the queue
        deadline = time.monotonic() + LIVENESS_S
        while l.prefetch_._ready.qsize() < depth:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        assert l.fill_counter[0] >= k + 1 + depth
    l.stop()
    sync = _loader(prefetch=0, n_valid=0, n_train=320)
    for k in range(5):
        sync.run()
        assert sync.fill_counter[0] == k + 1
    _wait_no_threads()


def test_gauges_and_input_wait_by_mode():
    from veles_tpu_torch import telemetry
    l = _loader(prefetch=2, name="gauged")
    for _ in range(6):
        l.run()
    l.stop()
    s = _loader(prefetch=0, name="gauged")
    for _ in range(4):
        s.run()
    m = telemetry.metrics
    assert m.gauge("veles_prefetch_depth", labelnames=("loader",)).labels(
        "gauged").value == 2
    assert m.counter("veles_prefetch_batches_total",
                     labelnames=("loader",)).labels("gauged").value == 6
    wait = m.histogram("veles_input_wait_seconds",
                       labelnames=("loader", "mode"))
    assert wait.labels("gauged", "prefetch").count == 6
    assert wait.labels("gauged", "sync").count == 4
    text = m.render_prometheus()
    for name in ("veles_prefetch_depth", "veles_prefetch_occupancy",
                 "veles_prefetch_batches_total",
                 "veles_input_wait_seconds"):
        assert name in text
    _wait_no_threads()


def test_popped_batch_is_on_the_device_already():
    """After a prefetched wave the minibatch Arrays hold their device
    tensor (installed at pop, equal to the host mirror), and the
    tensor is not the staging buffer: refilling the staging set leaves
    it as it was."""
    l = _loader(prefetch=2)
    held = []
    for _ in range(8):
        l.run()
        dev = l.minibatch_data._devmem_
        assert dev is not None
        numpy.testing.assert_array_equal(dev.numpy(),
                                         l.minibatch_data.mem)
        held.append((dev, dev.clone()))
    l.stop()
    for dev, copy in held:
        assert torch.equal(dev, copy)
