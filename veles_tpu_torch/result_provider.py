"""Result contribution contract (the port of
``veles_tpu/result_provider.py``; ref: veles/result_provider.py:1-58).

Units implementing :class:`IResultProvider` contribute to the JSON written
by ``--result-file`` (consumed by the genetics optimizer and ensemble
manager — ref: veles/workflow.py:827-849).
"""


class IResultProvider:
    """Mixin marker: implement :meth:`get_metric_values`."""

    def get_metric_values(self):
        """Return a dict of metric name -> picklable value."""
        raise NotImplementedError()
