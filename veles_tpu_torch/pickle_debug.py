"""Pickle debugging (the port of ``veles_tpu/pickle_debug.py``; rebuild
of veles/pickle2.py's debug hooks + ``--debug-pickle``): when a snapshot
fails to pickle, walk the object
graph and name exactly which attribute path is unpicklable — the raw
pickle error only names the innermost type."""

import pickle


def _try_pickle(obj):
    try:
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        return None
    except Exception as e:
        return "%s: %s" % (type(e).__name__, e)


def find_unpicklable(obj, path="<root>", max_depth=6, _seen=None):
    """[(attr path, error)] for the deepest unpicklable attributes."""
    _seen = _seen if _seen is not None else set()
    if id(obj) in _seen or max_depth < 0:
        return []
    _seen.add(id(obj))
    err = _try_pickle(obj)
    if err is None:
        return []
    if isinstance(obj, dict):
        items = [("[%r]" % k, v) for k, v in list(obj.items())]
    elif isinstance(obj, (list, tuple, set)):
        items = [("[%d]" % i, v) for i, v in enumerate(obj)]
    elif hasattr(obj, "__getstate__") or hasattr(obj, "__dict__"):
        try:
            state = obj.__getstate__() if hasattr(obj, "__getstate__") \
                else obj.__dict__
        except Exception:
            state = getattr(obj, "__dict__", {})
        if not isinstance(state, dict):
            state = {"<state>": state}
        items = [(".%s" % k, v) for k, v in state.items()]
    else:
        items = []
    found = []
    for name, child in items:
        child_err = _try_pickle(child)
        if child_err is not None:
            deeper = find_unpicklable(child, path + name, max_depth - 1,
                                      _seen)
            found.extend(deeper or [(path + name, child_err)])
    return found or [(path, err)]


def explain_pickle_failure(obj, logger=None):
    """Log (or return) a human-readable diagnosis."""
    rows = find_unpicklable(obj)
    lines = ["unpicklable attribute paths:"] + \
        ["  %s — %s" % (p, e) for p, e in rows[:20]]
    text = "\n".join(lines)
    if logger is not None:
        logger.error(text)
    return text
