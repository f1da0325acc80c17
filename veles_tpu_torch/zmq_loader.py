"""ZeroMQ streaming ingestion (the port of ``veles_tpu/zmq_loader.py``;
ref: veles/zmq_loader.py:74-138 — the Mastodon bridge's job feed).

A PULL socket receives pickled samples from any producer (the
reference's JVM/Hadoop bridge; here any pyzmq PUSH peer, the JAX
package's producers included) and serves them as minibatches through
the InteractiveLoader machinery: each minibatch crosses to the device
once, in the loader's ``unmap``.  A frame the restricted unpickler
refuses, or a sample of the wrong shape, is dropped with a warning;
``None`` closes the stream.  :meth:`ZeroMQLoader.stop` ends the
receiving thread and closes the socket."""

import threading

from veles_tpu_torch.loader.interactive import InteractiveLoader
from veles_tpu_torch.safe_pickle import safe_loads, warn_if_public

try:
    import zmq
    HAS_ZMQ = True
except ImportError:  # pragma: no cover
    HAS_ZMQ = False

#: how often (ms) the receiving thread looks at its stop flag
POLL_MS = 100


class ZeroMQLoader(InteractiveLoader):
    """PULL-socket loader (ref: veles/zmq_loader.py:74).  Producers
    ``send_pyobj(sample)``; ``send_pyobj(None)`` closes the stream."""

    def __init__(self, workflow, endpoint=None, **kwargs):
        super(ZeroMQLoader, self).__init__(workflow, **kwargs)
        #: "tcp://host:port" to bind; None binds a random tcp port
        self.endpoint = endpoint

    def init_unpickled(self):
        super(ZeroMQLoader, self).init_unpickled()
        self._sock_ = None
        self._recv_thread_ = None
        self._stop_ = threading.Event()

    def initialize(self, **kwargs):
        if not HAS_ZMQ:  # pragma: no cover
            raise RuntimeError("pyzmq is unavailable")
        super(ZeroMQLoader, self).initialize(**kwargs)
        if self._sock_ is not None:
            return
        ctx = zmq.Context.instance()
        self._sock_ = ctx.socket(zmq.PULL)
        if self.endpoint:
            self._sock_.bind(self.endpoint)
        else:
            port = self._sock_.bind_to_random_port("tcp://127.0.0.1")
            self.endpoint = "tcp://127.0.0.1:%d" % port
        self.info("ZeroMQ ingestion on %s", self.endpoint)
        warn_if_public(self.endpoint, self)
        self._stop_.clear()
        self._recv_thread_ = threading.Thread(
            target=self._receive_loop, args=(self._sock_,), daemon=True,
            name="zmq-ingest")
        self._recv_thread_.start()

    def _receive_loop(self, sock):
        while not self._stop_.is_set():
            try:
                if not sock.poll(POLL_MS):
                    continue
                blob = sock.recv()
            except zmq.ZMQError:  # pragma: no cover - socket closed
                break
            try:
                sample = safe_loads(blob)
                if sample is None:
                    self.close()
                    break
                self.feed(sample)
            except Exception as e:
                # one malformed producer frame must not kill the ingest
                # thread (and with it the whole stream)
                self.warning("dropped bad ingest frame: %s", e)

    def stop(self):
        """End the receiving thread and close the socket."""
        self._stop_.set()
        thread, self._recv_thread_ = self._recv_thread_, None
        if thread is not None:
            thread.join(5)
        sock, self._sock_ = self._sock_, None
        if sock is not None:
            sock.close(0)
        super(ZeroMQLoader, self).stop()
