"""Interactive loader (the port of ``veles_tpu/loader/interactive.py``):
a queue-fed loader for serving and notebook use — callers push samples
with :meth:`InteractiveLoader.feed`, the graph consumes them as
minibatches.  Nothing can be produced ahead of the waves, so it opts
out of the prefetch pipeline (``prefetchable = False``)."""

import queue

import numpy

from veles_tpu_torch.loader.base import TEST, Loader


class InteractiveLoader(Loader):
    """Samples arrive at run time; every minibatch is TEST class (no
    labels, no epochs — the graph loops while the feed stays open)."""

    #: serving blocks on a live request queue — there is nothing to
    #: produce ahead of the waves (and run() is overridden anyway)
    prefetchable = False

    def __init__(self, workflow=None, sample_shape=None, max_wait=30.0,
                 **kwargs):
        super(InteractiveLoader, self).__init__(workflow, **kwargs)
        if sample_shape is None:
            raise ValueError("sample_shape is required")
        self._sample_shape = tuple(sample_shape)
        self.max_wait = max_wait

    @property
    def sample_shape(self):
        """One fed sample's shape (fixed at construction)."""
        return self._sample_shape

    def init_unpickled(self):
        super(InteractiveLoader, self).init_unpickled()
        self._queue_ = queue.Queue()
        self._closed_ = False

    # -- feeding --------------------------------------------------------------

    def feed(self, sample):
        """Queue one sample (numpy, matching sample_shape)."""
        sample = numpy.asarray(sample, numpy.float32)
        if sample.shape != self.sample_shape:
            raise ValueError("sample shape %s != %s"
                             % (sample.shape, self.sample_shape))
        self._queue_.put(sample)

    def close(self):
        """No more samples — the workflow's loop gate should close."""
        self._closed_ = True
        self._queue_.put(None)

    @property
    def closed(self):
        return self._closed_

    # -- ILoader --------------------------------------------------------------

    def load_data(self):
        # an unbounded interactive stream: advertise one TEST "sample"
        # so the epoch machinery has a non-empty space to walk; serving
        # blocks on the queue instead of indexing a dataset
        self.class_lengths[:] = [1, 0, 0]

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.sample_shape,
            numpy.float32))

    def fill_minibatch(self):
        pass  # serving happens in run()

    def run(self):
        """Block for at least one sample, then drain up to a full
        minibatch."""
        samples = []
        try:
            first = self._queue_.get(timeout=self.max_wait)
        except queue.Empty:
            # idle feed: serve an empty minibatch WITHOUT closing — only
            # close() ends the stream (an idle REST endpoint must keep
            # serving later requests)
            first = None
        if first is not None:
            samples.append(first)
            while len(samples) < self.max_minibatch_size:
                try:
                    s = self._queue_.get_nowait()
                except queue.Empty:
                    break
                if s is None:
                    self._closed_ = True
                    break
                samples.append(s)
        self.minibatch_class = TEST
        self.minibatch_size = len(samples)
        self.minibatch_data.map_invalidate()
        self.minibatch_data.mem[:] = 0
        for i, s in enumerate(samples):
            self.minibatch_data.mem[i] = s
        self.minibatch_data.unmap()
        self.samples_served += len(samples)
        self.last_minibatch.set(True)
        self.epoch_ended.set(self._closed_)
