"""Avatar — cross-workflow Array bridging (the port of
``veles_tpu/avatar.py``; ref: veles/avatar.py:22).

One workflow exposes chosen Arrays through an :class:`AvatarServer`
(ZMQ REP); an :class:`Avatar` unit in another process or workflow pulls
fresh copies each run.  The wire is the reference's: the request is a
pickled list of names (None: every exposed Array), the reply a pickled
``{name: numpy array}``, decoded on both ends by the restricted
unpickler, so either package's Avatar pulls from either's server.

The server reads each requested Array to the host once per request
(``map_read``: one device-to-host copy of a tensor the device wrote
since the last read); the Avatar's mirrors are Arrays bound to its own
device, uploaded on their first ``devmem`` read.
"""

import pickle

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.memory import Array
from veles_tpu_torch.safe_pickle import safe_loads, warn_if_public
from veles_tpu_torch.units import Unit

try:
    import zmq
    HAS_ZMQ = True
except ImportError:  # pragma: no cover
    HAS_ZMQ = False


class AvatarServer(Logger):
    """REP endpoint serving {name: Array} snapshots on demand."""

    def __init__(self, arrays, port=0, host="127.0.0.1"):
        super(AvatarServer, self).__init__()
        if not HAS_ZMQ:  # pragma: no cover
            raise RuntimeError("pyzmq is unavailable")
        self.arrays = dict(arrays)
        self._sock = zmq.Context.instance().socket(zmq.REP)
        if port:
            self._sock.bind("tcp://%s:%d" % (host, port))
            self.port = port
        else:
            self.port = self._sock.bind_to_random_port("tcp://" + host)
        self.endpoint = "tcp://%s:%d" % (host, self.port)
        self.info("avatar server on %s", self.endpoint)
        warn_if_public(self.endpoint, self)

    def serve_once(self, timeout=5000):
        """Answer one request; returns False on timeout."""
        if not self._sock.poll(timeout):
            return False
        names = safe_loads(self._sock.recv())
        payload = {}
        for name in names or self.arrays:
            arr = self.arrays.get(name)
            if isinstance(arr, Array):
                payload[name] = arr.map_read().mem
        self._sock.send(pickle.dumps(
            payload, protocol=pickle.HIGHEST_PROTOCOL))
        return True

    def close(self):
        self._sock.close(0)


class Avatar(Unit):
    """Pulls remote Arrays into local mirrors each run
    (ref: veles/avatar.py:22)."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, endpoint=None, names=(), timeout=5.0,
                 **kwargs):
        super(Avatar, self).__init__(workflow, **kwargs)
        self.endpoint = endpoint
        self.names = list(names)
        self.timeout = timeout
        #: name -> local Array mirror, created on first fetch
        self.mirrors = {}
        #: the device the mirrors live on (None: the port's default)
        self.device = None
        self.demand("endpoint")

    def init_unpickled(self):
        super(Avatar, self).init_unpickled()
        self._sock_ = None

    def initialize(self, device=None, **kwargs):
        super(Avatar, self).initialize(**kwargs)
        if device is not None:
            self.device = device

    def _connect(self):
        if not HAS_ZMQ:  # pragma: no cover
            raise RuntimeError("pyzmq is unavailable")
        if self._sock_ is None:
            self._sock_ = zmq.Context.instance().socket(zmq.REQ)
            self._sock_.connect(self.endpoint)

    def run(self):
        self._connect()
        self._sock_.send(pickle.dumps(self.names or None))
        if not self._sock_.poll(self.timeout * 1000):
            raise TimeoutError("avatar source %s silent" % self.endpoint)
        payload = safe_loads(self._sock_.recv())
        for name, mem in payload.items():
            mirror = self.mirrors.get(name)
            if mirror is None:
                mirror = self.mirrors[name] = Array()
            mirror.reset(mem)
            mirror.initialize(self.device)

    def close(self):
        """Close the request socket (a later run reconnects)."""
        if self._sock_ is not None:
            self._sock_.close(0)
            self._sock_ = None
