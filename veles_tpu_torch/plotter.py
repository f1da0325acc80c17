"""Plotter base — live-visualization units (the port of
``veles_tpu/plotter.py``).

Plotting units run inside the training graph, but rendering happens
out of process: a unit's ``run()`` only snapshots host-side state into
a small picklable *payload* (a plain dict of builtins — no class of
either package), which the launcher's
:class:`~veles_tpu_torch.graphics_server.GraphicsServer` fans out over
ZMQ PUB to any number of :mod:`~veles_tpu_torch.graphics_client`
processes (matplotlib lives there, never in the training process).
A payload reads a device tensor through one copy to the host; it
launches nothing on the device.
"""

import time

from veles_tpu_torch.units import Unit


class Plotter(Unit):
    """Base plotting unit.

    Subclasses implement :meth:`payload`, a picklable dict with at least
    ``kind`` (the client's renderer key).  ``run()`` publishes it through
    the launcher's graphics server when one is live; the latest payload
    is kept on ``last_payload``.
    """

    VIEW_GROUP = "PLOTTER"

    def __init__(self, workflow, name=None, collect=False, **kwargs):
        super(Plotter, self).__init__(workflow, name=name, **kwargs)
        self.last_payload = None
        #: build payloads without a publisher too (tests, direct
        #: rendering); off by default: a payload reads device tensors,
        #: which a plain run's loop must not wait for
        self.collect = collect

    @property
    def graphics_server(self):
        launcher = getattr(self._workflow, "launcher", None)
        return getattr(launcher, "graphics_server", None)

    def payload(self):
        raise NotImplementedError()

    def run(self):
        server = self.graphics_server
        if server is None and not self.collect:
            return
        data = self.payload()
        if data is None:
            return
        data.setdefault("name", self.name)
        data.setdefault("time", time.time())
        self.last_payload = data
        if server is not None:
            server.enqueue(data)
