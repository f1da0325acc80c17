"""Import a workflow file as a module (the port of
``veles_tpu/import_file.py``)."""

import importlib.util
import os
import sys


def import_file_as_module(path, name=None):
    path = os.path.abspath(path)
    name = name or os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    # registered so pickling classes defined in the workflow file works
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
