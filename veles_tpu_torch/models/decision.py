"""DecisionGD + Rollback — training control (the port of
``veles_tpu/models/decision.py``; znicz decision.py / rollback.py).

DecisionGD accumulates per-class error counts over each epoch, tracks
the best validation error, raises ``improved`` when a new minimum lands
(the snapshotter gates on it) and ``complete`` when validation stopped
improving for ``fail_iterations`` epochs or ``max_epochs`` passed (the
workflow's end gate).

Rollback keeps a host-side copy of the best parameters and solver slots;
on plateau it restores them and scales the trainer's learning rate.
"""

import torch

from veles_tpu_torch.loader.base import CLASS_NAME, TEST, TRAIN, VALID
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.units import Unit


class DecisionGD(Unit, IResultProvider):
    """Stopping / bookkeeping logic (znicz decision.DecisionGD)."""

    VIEW_GROUP = "PLUMBING"

    def __init__(self, workflow, fail_iterations=100, max_epochs=None,
                 **kwargs):
        super(DecisionGD, self).__init__(workflow, **kwargs)
        self.fail_iterations = fail_iterations
        self.max_epochs = max_epochs
        self.loader = None
        self.trainer = None      # supplies the epoch accumulator
        self.complete = Bool(False, "complete")
        self.improved = Bool(False, "improved")
        self.epoch_n_err = [0, 0, 0]
        self.epoch_samples = [0, 0, 0]
        self.epoch_loss_sum = [0.0, 0.0, 0.0]
        self.epoch_metrics = {}
        self.min_validation_n_err = None
        self.min_validation_n_err_epoch = -1
        self.best_train_n_err = None
        #: one row per closed train epoch, ``samples.lm.train_lm``'s
        #: keys: epoch, step, and the epoch's validation and train
        #: losses and error percentages (a port addition)
        self.history = []
        #: this epoch's validation metrics, for its history row
        self._epoch_eval = {}
        #: master-side epoch counter — with several async workers the
        #: loader's serve-time flags are not observable at update-apply
        #: time, so the master counts epochs by applied sample totals
        self._master_epoch = 0
        self.demand("loader", "trainer")

    @property
    def effective_epoch(self):
        return self._master_epoch if self.is_master \
            else self.loader.epoch_number

    def _loss_driven(self):
        ev = getattr(self.trainer, "evaluator", None)
        return bool(getattr(ev, "TARGETS", False))

    @property
    def validation_error_pct(self):
        """Last closed epoch's validation error % (plotter feed)."""
        return self.epoch_metrics.get("validation_error_pct")

    @property
    def fail_count(self):
        return (self.effective_epoch -
                max(self.min_validation_n_err_epoch, 0))

    def run(self):
        """Per-minibatch accounting stays ON DEVICE (trainer.epoch_acc);
        this unit syncs with the device only at epoch boundaries — the
        per-step host read the reference did (znicz decision) would
        serialize every dispatch."""
        if self.is_slave:
            # one job = one minibatch wave: close the loop gate so
            # do_job's run() returns; epoch accounting happens on the
            # master from the acc deltas workers send (znicz decision
            # behaved the same way on slaves)
            self.complete.set(True)
            if self._workflow is not None:
                self._workflow.on_workflow_finished()
            return
        self._evaluate_epoch()

    def _evaluate_epoch(self):
        l = self.loader
        self.improved.set(False)
        if l.epoch_ended:
            self._close_eval_epoch()
        if l.train_ended:
            self._close_train_epoch()

    def _close_eval_epoch(self):
        """Read + reset the TEST/VALID accumulator rows and evaluate the
        epoch (shared by the standalone and master paths)."""
        acc = self.trainer.read_epoch_acc(reset_classes=(TEST, VALID))
        self._last_eval_acc = acc[VALID]
        for cls in (TEST, VALID):
            n_err, loss_sum, samples = acc[cls]
            self.epoch_n_err[cls] = int(n_err)
            self.epoch_samples[cls] = int(samples)
            self.epoch_loss_sum[cls] = loss_sum
        self._on_epoch_ended()

    def _close_train_epoch(self):
        acc = self.trainer.read_epoch_acc(reset_classes=(TRAIN,))
        n_err, loss_sum, samples = acc[TRAIN]
        self.epoch_n_err[TRAIN] = int(n_err)
        self.epoch_samples[TRAIN] = int(samples)
        self.epoch_loss_sum[TRAIN] = loss_sum
        row = {"epoch": int(self.effective_epoch),
               "step": int(self.trainer.global_step)}
        for name in ("validation_loss", "validation_error_pct"):
            if name in self._epoch_eval:
                row[name] = self._epoch_eval[name]
        if samples:
            row["train_loss"] = loss_sum / samples
            row["train_error_pct"] = 100.0 * n_err / samples
        self.history.append(row)
        self._epoch_eval = {}
        if self.is_master:
            self._master_epoch += 1
        self._maybe_complete()
        self.epoch_n_err[TRAIN] = 0
        self.epoch_samples[TRAIN] = 0
        self.epoch_loss_sum[TRAIN] = 0.0

    def _error_pct(self, cls):
        n = self.epoch_samples[cls]
        return 100.0 * self.epoch_n_err[cls] / n if n else 0.0

    def _on_epoch_ended(self):
        l = self.loader
        for cls in (TEST, VALID):
            if self.epoch_samples[cls]:
                self.epoch_metrics["%s_error_pct" % CLASS_NAME[cls]] = \
                    self._error_pct(cls)
                self.epoch_metrics["%s_loss" % CLASS_NAME[cls]] = \
                    self.epoch_loss_sum[cls] / self.epoch_samples[cls]
        if self.epoch_samples[VALID]:
            acc = self._last_eval_acc
            self._epoch_eval = {
                "validation_loss": acc[1] / acc[2],
                "validation_error_pct": 100.0 * acc[0] / acc[2]}
        cls = VALID if self.epoch_samples[VALID] else TEST
        n_err = self.epoch_n_err[cls]
        loss = self.epoch_loss_sum[cls] / max(self.epoch_samples[cls], 1)
        # MSE workflows carry no n_err signal — improvement is tracked on
        # the validation loss instead (znicz decision tracked epoch_metrics
        # per evaluator kind)
        metric = loss if self._loss_driven() else n_err
        # loss-history divergence detection (EMA + patience) feeds the
        # health monitor; a 'halt' verdict ends the run gracefully at
        # this epoch boundary instead of burning chips on a diverged
        # model (telemetry/health.py)
        from veles_tpu_torch.telemetry import health as health_lib
        if health_lib.health_config()["enabled"]:
            verdict = health_lib.monitor.observe_loss(loss)
            if verdict == "halt":
                self.warning(
                    "health policy 'halt': validation loss diverged "
                    "- stopping")
                self.complete.set(True)
        if self.min_validation_n_err is None \
                or metric < self.min_validation_n_err:
            self.min_validation_n_err = metric
            self.min_validation_n_err_epoch = self.effective_epoch
            self.improved.set(True)
        self.info(
            "epoch %d: validation err %.2f%% (best %s @ epoch %d), "
            "val loss %.4f",
            self.effective_epoch, self._error_pct(VALID),
            self.min_validation_n_err, self.min_validation_n_err_epoch,
            self.epoch_metrics.get("validation_loss", float("nan")))
        self._maybe_complete()
        for cls in (TEST, VALID):
            self.epoch_n_err[cls] = 0
            self.epoch_samples[cls] = 0
            self.epoch_loss_sum[cls] = 0.0

    def _maybe_complete(self):
        if self.max_epochs is not None \
                and self.effective_epoch >= self.max_epochs:
            self.complete.set(True)
        if self.min_validation_n_err is not None \
                and self.fail_count > self.fail_iterations:
            self.info("no improvement for %d epochs — stopping",
                      self.fail_iterations)
            self.complete.set(True)
        if self.complete and self._workflow is not None:
            self._workflow.on_workflow_finished()

    # -- elastic DCN sync: the master evaluates epochs as worker updates
    #    land (its graph never runs); workers just reset their loop gate --

    negotiates_on_connect = True

    def generate_data_for_slave(self, slave=None):
        return True  # presence alone triggers the worker-side reset

    def apply_data_from_master(self, data):
        self.complete.set(False)

    def generate_data_for_master(self):
        return True

    def apply_data_from_slave(self, data, slave=None):
        """Master: with several async workers the loader's serve-time
        flags aren't observable here (another worker may already hold
        next-epoch jobs), so epochs complete when the *applied* sample
        totals in the trainer's accumulator reach the class lengths
        (the reference master was equally asynchronous about it)."""
        l = self.loader
        acc = self.trainer.read_epoch_acc()
        self.improved.set(False)
        # every eval class present in the dataset must be fully applied
        # before the epoch closes — gating on VALID alone would let a
        # slow worker's in-flight TEST minibatch leak into the next epoch
        eval_classes = [c for c in (TEST, VALID) if l.class_lengths[c]]
        if eval_classes and all(
                acc[c][2] >= l.class_lengths[c] for c in eval_classes):
            self._close_eval_epoch()
        train_needed = l.effective_total_samples - l.class_end_offsets[VALID]
        if train_needed and acc[TRAIN][2] >= train_needed:
            self._close_train_epoch()

    def drop_slave(self, slave=None):
        pass

    def get_metric_values(self):
        out = dict(self.epoch_metrics)
        if self.min_validation_n_err is not None:
            out["min_validation_n_err"] = self.min_validation_n_err
            out["min_validation_n_err_epoch"] = \
                self.min_validation_n_err_epoch
        return out


class Rollback(Unit):
    """Best-state keeper (znicz rollback; extras item 11): saves params
    on improvement; after ``fail_iterations`` epochs without improvement
    restores them and multiplies the trainer's learning rate by
    ``lr_plus``."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, fail_iterations=10, lr_plus=0.5, **kwargs):
        super(Rollback, self).__init__(workflow, **kwargs)
        self.fail_iterations = fail_iterations
        self.lr_plus = lr_plus
        self.decision = None
        self.trainer = None
        self.saved_params = None
        self.saved_opt_state = None
        self._last_restore_epoch = -1
        self.demand("decision", "trainer")

    def run(self):
        d = self.decision
        if d.improved:
            self.save()
        elif (self.saved_params is not None
              and d.loader.epoch_ended
              and d.fail_count and d.fail_count % self.fail_iterations == 0
              and d.loader.epoch_number != self._last_restore_epoch):
            self.restore()
            self._last_restore_epoch = d.loader.epoch_number

    def save(self):
        """Host copies of the chain's parameters and the solver slots
        (they belong to the trajectory: restoring weights under a stale
        velocity would push them straight back)."""
        params, opt_state = self.trainer.state_tensors()
        self.saved_params = {
            i: {n: p.detach().cpu().clone() for n, p in layer.items()}
            for i, layer in params.items()}
        self.saved_opt_state = {
            key: {s: v.detach().cpu().clone() for s, v in slots.items()}
            for key, slots in opt_state.items()}

    def restore(self):
        self.info("rolling back to best params; lr *= %s", self.lr_plus)
        t = self.trainer
        t.write_state(self.saved_params, self.saved_opt_state)
        t.lr_multiplier *= self.lr_plus
