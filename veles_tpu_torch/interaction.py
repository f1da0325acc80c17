"""Interaction — the Shell unit (the port of ``veles_tpu/interaction.py``):
drops into a live REPL mid-graph with the workflow in scope.  IPython
when importable, the stdlib's ``code.interact`` otherwise; ``gate_skip``
makes it a no-op until a debugging session flips the gate."""

from veles_tpu_torch.units import Unit


class Shell(Unit):
    """An interactive break-point unit."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow, banner=None, once=True, **kwargs):
        super(Shell, self).__init__(workflow, **kwargs)
        self.banner = banner or (
            "veles_tpu_torch shell — `workflow`, `unit` are live; Ctrl-D "
            "resumes the graph")
        #: open the shell only on the first run (default) or every run
        self.once = once
        self._fired = False
        #: tests inject a callable instead of a real terminal session
        self.interact_hook = None

    def run(self):
        if self.once and self._fired:
            return
        self._fired = True
        scope = {"workflow": self._workflow, "unit": self,
                 "launcher": getattr(self._workflow, "launcher", None)}
        if self.interact_hook is not None:
            self.interact_hook(scope)
            return
        try:  # interactive only
            from IPython import embed
            embed(banner1=self.banner, user_ns=scope)
        except ImportError:
            import code
            code.interact(banner=self.banner, local=scope)
