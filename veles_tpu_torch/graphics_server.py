"""GraphicsServer — ZMQ PUB fan-out of plot payloads (the port of
``veles_tpu/graphics_server.py``).

The training process binds a PUB socket and pushes each plotter payload
as one gzip-pickled message; any number of client processes subscribe
(:mod:`veles_tpu_torch.graphics_client`).  Payloads are plain dicts of
builtins: :func:`veles_tpu_torch.safe_pickle.safe_loads` reads them, and
they name no class of either package.  Without ``pyzmq`` the server
raises at construction: nothing is published silently into the void.
"""

import gzip
import pickle

from veles_tpu_torch.logger import Logger

try:
    import zmq
    HAS_ZMQ = True
except ImportError:  # the card's machine may lack it
    zmq = None
    HAS_ZMQ = False


class GraphicsServer(Logger):
    """A PUB endpoint for plot payloads on ``host``, at ``port`` (0: one
    the system picks)."""

    def __init__(self, port=0, host="127.0.0.1"):
        super(GraphicsServer, self).__init__()
        if not HAS_ZMQ:
            raise RuntimeError(
                "the graphics server needs pyzmq, which is not installed")
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        self._sock.setsockopt(zmq.LINGER, 0)
        if port:
            self._sock.bind("tcp://%s:%d" % (host, port))
            self.port = port
        else:
            self.port = self._sock.bind_to_random_port("tcp://" + host)
        self.endpoint = "tcp://%s:%d" % (host, self.port)
        self.sent = 0
        self.info("graphics PUB on %s", self.endpoint)

    def enqueue(self, payload):
        """Publish one plot payload without blocking: a slow subscriber
        drops payloads, training never waits for it."""
        blob = gzip.compress(
            pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL), 1)
        try:
            self._sock.send(blob, zmq.NOBLOCK)
            self.sent += 1
        except zmq.ZMQError:
            pass

    def close(self):
        self._sock.close(0)
