"""REST model serving workflow — the port of ``veles_tpu/samples/serve.py``:
load a trained snapshot (the port's, or one the JAX package wrote) and
serve its forward chain over HTTP.

    python -m veles_tpu_torch veles_tpu_torch/samples/serve.py \\
        -c "root.serve.snapshot = 'snapshots/mnist_current.pickle.gz'" \\
        -c "root.serve.port = 8080"

    curl -X POST http://localhost:8080/api -d '{"input": [0.0, 0.1, ...]}'
    curl -X POST http://localhost:8080/generate \\
         -d '{"prompt": [3, 1, 4], "steps": 32}'   # LM snapshots only
    curl -X POST http://localhost:8080/shutdown    # clean stop

Graph: repeater → loader → chain → api → repeater, looping until
``/shutdown`` closes the feed.  The port's forward units are modules,
not workflow units, so one :class:`ChainForward` unit runs the adopted
chain on each minibatch.  Waves that served no request skip the chain
and the api through their ``gate_skip`` (the loader's ``idle`` Bool);
``stop_requested`` blocks the loader and opens the end point.  An LM
snapshot (a ``TokenProjection`` head) also serves ``/generate`` and the
OpenAI routes through the scheduler, whose knobs ride
``root.common.serving`` (``-c "root.common.serving.kv_dtype = 'int8'"``).
"""

import torch

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
from veles_tpu_torch.memory import Array
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.restful_api import RESTfulAPI, RestfulLoader
from veles_tpu_torch.units import Unit


class _ServingLoader(RestfulLoader):
    """RestfulLoader that publishes its idle and closed states as gate
    Bools."""

    def __init__(self, workflow, **kwargs):
        super(_ServingLoader, self).__init__(workflow, **kwargs)
        #: True while the last serve produced no samples: the chain and
        #: the api are gate-skipped on idle waves
        self.idle = Bool(False, "idle")
        self.stop_requested = Bool(False, "stop_requested")

    def run(self):
        super(_ServingLoader, self).run()
        self.idle.set(self.minibatch_size == 0)
        if self.closed:
            self.stop_requested.set(True)


class ChainForward(Unit):
    """Runs the forward chain ``forwards`` on the loader's minibatch
    (no autograd) into :attr:`output` (an Array of the chain's output,
    its rows past the minibatch's size those of the padded rows)."""

    VIEW_GROUP = "WORKER"

    def __init__(self, workflow, forwards=None, loader=None, **kwargs):
        super(ChainForward, self).__init__(workflow, **kwargs)
        self.forwards = list(forwards or [])
        self.loader = loader
        self.output = Array()
        self.device = None
        self.demand("forwards", "loader")

    def initialize(self, device=None, **kwargs):
        super(ChainForward, self).initialize(**kwargs)
        from veles_tpu_torch.backends import resolve_device
        self.device = resolve_device(device)
        for u in self.forwards:
            u.to_device(self.device)

    def run(self):
        from veles_tpu_torch.models.embedding import Embedding
        x = self.loader.minibatch_data.devmem.to(self.device)
        if isinstance(self.forwards[0], Embedding):
            x = x.long()
        with torch.no_grad():
            for u in self.forwards:
                x = u.apply(x)
        self.output.reset(x.float().cpu().numpy())


class ServeWorkflow(AcceleratedWorkflow):
    """Serves the forward chain of ``snapshot``; its keyword arguments
    are ``root.serve``'s keys.  ``workflow_file`` (``root.serve.
    workflow``) is imported first when the snapshot names the classes
    of a workflow file the port has no sample of."""

    def __init__(self, workflow=None, snapshot=None, workflow_file=None,
                 port=0, host="127.0.0.1", serving=True, max_slots=4,
                 max_queue=32, minibatch_size=16, max_wait=1.0,
                 **kwargs):
        super(ServeWorkflow, self).__init__(workflow, name="Serve",
                                            **kwargs)
        if not snapshot:
            raise ValueError(
                "set root.serve.snapshot to a trained workflow snapshot")
        from veles_tpu_torch.snapshotter import SnapshotterToFile
        if workflow_file:
            from veles_tpu_torch.import_file import import_file_as_module
            import_file_as_module(workflow_file)
        trained = SnapshotterToFile.import_file(snapshot)
        #: the adopted trained chain
        self.forwards = list(getattr(trained, "gd", trained).forwards)
        sample_shape = tuple(self.forwards[0].in_shape)

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        self.loader = _ServingLoader(
            self, sample_shape=sample_shape,
            minibatch_size=int(minibatch_size), max_wait=float(max_wait))
        self.loader.link_from(self.repeater)

        self.chain = ChainForward(self, forwards=self.forwards,
                                  loader=self.loader)
        self.chain.link_from(self.loader)
        self.chain.gate_skip = self.loader.idle

        from veles_tpu_torch.models.transformer import TokenProjection
        self.api = RESTfulAPI(
            self, loader=self.loader, port=int(port), host=host,
            serving=bool(serving), max_slots=int(max_slots),
            max_queue=int(max_queue),
            # an LM snapshot (a per-token logits head) also serves
            # POST /generate off the same chain
            forwards=self.forwards
            if isinstance(self.forwards[-1], TokenProjection) else None)
        self.api.output = self.chain.output
        self.api.gate_skip = self.loader.idle
        self.api.shutdown_callback = self.request_stop
        self.api.link_from(self.chain)

        # the training graph's termination handshake: stop_requested
        # blocks the loader and opens the end point
        self.repeater.link_from(self.api)
        self.loader.gate_block = self.loader.stop_requested
        self.end_point.link_from(self.api)
        self.end_point.gate_block = ~self.loader.stop_requested

    def initialize(self, **kwargs):
        super(ServeWorkflow, self).initialize(**kwargs)
        self.info("serving on http://%s:%d/api (POST {\"input\": ...}; "
                  "POST /shutdown to stop)", self.api.host, self.api.port)

    def request_stop(self):
        """Thread-safe stop: close the feed; the next wave ends the loop
        through the gates."""
        self.loader.stop_requested.set(True)
        self.loader.close()

    def run(self):
        try:
            super(ServeWorkflow, self).run()
        finally:
            self.api.stop()

    def stop(self):
        self.request_stop()
        super(ServeWorkflow, self).stop()


def run(load, main):
    """The command line's entry: the workflow from ``root.serve``
    (``workflow`` there names ``workflow_file``)."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import config_kwargs
    kw = config_kwargs(ServeWorkflow, root.serve)
    if root.serve.get("workflow"):
        kw["workflow_file"] = root.serve.get("workflow")
    load(ServeWorkflow, **kw)
    main()
