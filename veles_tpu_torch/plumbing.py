"""Plumbing units: StartPoint, EndPoint and Repeater (the port of
``veles_tpu/plumbing.py``; ref: veles/plumbing.py:17-60)."""

from veles_tpu_torch.units import Unit


class StartPoint(Unit):
    """Workflow entry node; firing it starts a graph wave."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Start")
        super(StartPoint, self).__init__(workflow, **kwargs)


class EndPoint(Unit):
    """Workflow exit node; running it finishes the workflow run."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "End")
        super(EndPoint, self).__init__(workflow, **kwargs)

    def run(self):
        self.workflow.on_workflow_finished()

    def run_dependent(self):
        pass  # nothing runs after the end


class Repeater(Unit):
    """Loop head: fires on ANY incoming signal (start edge or loop-back
    edge), unlike the default all-inputs gate — this is what makes training
    loops expressible in the graph (ref: veles/plumbing.py, Repeater)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Repeater")
        super(Repeater, self).__init__(workflow, **kwargs)

    def open_gate(self, src):
        for k in self.links_from:
            self.links_from[k] = False
        return True
