"""Kohonen map demo — the port of ``veles_tpu/samples/kohonen.py`` (the
reference's DemoKohonen workflow): a SOM grid organizes over 2-D
Gaussian clusters.  Its keyword arguments are the reference's
``root.kohonen_tpu`` keys with their defaults.

    wf = KohonenWorkflow(samples=512, max_epochs=2)
    wf.initialize(device="cpu"); wf.run()
    wf.decision.epoch_qerror
"""

import numpy

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.kohonen import (
    KohonenDecision, KohonenForward, KohonenTrainer)
from veles_tpu_torch.plumbing import Repeater


class ClustersLoader(FullBatchLoader):
    """2-D points around ``clusters`` Gaussian centers (the DemoKohonen
    dataset shape), drawn from ``default_rng(7)``."""

    span_serving = False  # per-minibatch serving: the SOM trainer is
    # not a span consumer

    def __init__(self, workflow, samples=2048, clusters=4, **kwargs):
        super(ClustersLoader, self).__init__(workflow, **kwargs)
        self.samples = int(samples)
        self.clusters = int(clusters)

    def load_data(self):
        rng = numpy.random.default_rng(7)
        n, k = self.samples, self.clusters
        centers = rng.uniform(-1.0, 1.0, size=(k, 2))
        idx = rng.integers(0, k, n)
        pts = centers[idx] + rng.normal(scale=0.08, size=(n, 2))
        self.class_lengths[:] = [0, 0, n]
        self.original_data = pts.astype(numpy.float32)


class KohonenWorkflow(AcceleratedWorkflow):
    """start → repeater → loader → trainer → forward (once per epoch) →
    decision ─┬→ repeater; └→ end, gated as the reference gates them."""

    def __init__(self, workflow=None, shape=(8, 8), samples=2048,
                 clusters=4, minibatch_size=256, learning_rate=0.5,
                 max_epochs=10, seed=None, **kwargs):
        super(KohonenWorkflow, self).__init__(workflow, name="Kohonen",
                                              **kwargs)
        shape = tuple(shape)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        self.loader = ClustersLoader(
            self, samples=samples, clusters=clusters,
            minibatch_size=int(minibatch_size))
        self.loader.link_from(self.repeater)
        self.trainer = KohonenTrainer(
            self, loader=self.loader, shape=shape,
            learning_rate=float(learning_rate), seed=seed)
        self.trainer.link_from(self.loader)
        self.forward = KohonenForward(self, shape=shape)
        self.forward.link_attrs(self.trainer, "weights")
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"))
        # the BMU mapping is the inference surface — run it once per
        # epoch, not per minibatch (the trainer computes its own winners)
        self.forward.gate_skip = ~self.loader.train_ended
        self.forward.link_from(self.trainer)
        self.decision = KohonenDecision(self, max_epochs=int(max_epochs))
        self.decision.loader = self.loader
        self.decision.trainer = self.trainer
        self.decision.link_from(self.forward)
        self.repeater.link_from(self.decision)
        self.loader.gate_block = self.decision.complete
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete

    @classmethod
    def from_jax(cls, rec):
        """This workflow built from the record of a JAX package snapshot
        (:mod:`veles_tpu_torch.jax_snapshot`): the map's shape, the
        dataset's size, the minibatch, learning rate and epoch budget
        from the records (the clusters from ``root.kohonen_tpu``, where
        the JAX loader reads them), then the loader's position, the
        trainer's map, clock and generator and the decision's history
        and gates."""
        from veles_tpu_torch import jax_snapshot
        from veles_tpu_torch.config import root
        loader, trainer = rec.get("loader"), rec.get("trainer")
        decision = rec.get("decision")
        wf = cls(None, shape=tuple(trainer.get("shape")),
                 samples=int(loader.get("class_lengths")[2]),
                 clusters=int(root.kohonen_tpu.get("clusters", 4)),
                 minibatch_size=int(loader.get("max_minibatch_size")),
                 learning_rate=float(trainer.get("learning_rate")),
                 max_epochs=int(decision.get("max_epochs")))
        jax_snapshot.take_plain(wf.loader, loader,
                                skip=("device", "prefetch"))
        jax_snapshot.take_plain(wf.trainer, trainer,
                                skip=("device", "weights", "qerror",
                                      "loader"))
        weights = jax_snapshot.array_of(trainer.get("weights"))
        if weights is not None:
            wf.trainer.weights = numpy.array(weights, numpy.float32)
        jax_snapshot.take_plain(wf.decision, decision)
        wf._restored_from_snapshot_ = True
        return wf


def run(load, main):
    """The command line's entry: the workflow from ``root.kohonen_tpu``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import config_kwargs
    load(KohonenWorkflow, **config_kwargs(KohonenWorkflow, root.kohonen_tpu))
    main()
