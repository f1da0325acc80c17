"""Publisher unit (the port of ``veles_tpu/publishing/publisher.py``;
rebuild of veles/publishing/publisher.py:57):
collects everything a training-run report needs — workflow identity,
config, metrics, unit timings, plot payloads, the graph DOT — and hands
it to a rendering backend."""

import datetime
import os

from veles_tpu_torch.config import root
from veles_tpu_torch.units import Unit


class Publisher(Unit):
    """End-of-train report generator.  Gate it on ``decision.complete``
    (the standard wiring) so it fires once, at the end."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, backend="markdown", output_dir=None,
                 title=None, backend_config=None, **kwargs):
        super(Publisher, self).__init__(workflow, **kwargs)
        self.backend_name = backend
        self.backend_config = dict(backend_config or {})
        self.output_dir = output_dir
        self.title = title
        self.destination = None
        #: the backend instance of the last run (its render state)
        self.backend = None

    def gather(self):
        """The report payload (ref: publisher.py collecting metrics,
        plots and the workflow graph)."""
        wf = self._workflow
        payload = {
            "title": self.title or "%s report" % wf.name,
            "generated": datetime.datetime.now().isoformat(
                timespec="seconds"),
            "workflow": wf.name,
            "workflow_class": type(wf).__name__,
            "checksum": wf.checksum(),
            "metrics": wf.gather_results(),
            "config": root.__content__(),
            "units": [
                {"name": u.name, "class": type(u).__name__,
                 "runs": u.timers.get("runs", 0),
                 "seconds": round(u.timers.get("run", 0.0), 4)}
                for u in wf.units],
            "graph_dot": wf.generate_graph(),
            "plots": {},
        }
        for u in wf.units:
            if getattr(u, "last_payload", None):
                payload["plots"][u.name] = u.last_payload
        return payload

    def run(self):
        from veles_tpu_torch.publishing.backends import BACKENDS
        cls = BACKENDS[self.backend_name]
        backend = cls(**self.backend_config) if self.backend_config \
            else cls()
        out_dir = self.output_dir \
            or root.common.dirs.get("snapshots", ".")
        os.makedirs(out_dir, exist_ok=True)
        payload = self.gather()
        self.backend = backend
        self.destination = backend.render(payload, out_dir)
        self.info("report -> %s", self.destination)
