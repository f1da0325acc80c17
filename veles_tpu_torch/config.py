"""The global configuration tree — the port's own copy of
``veles_tpu/config.py``.

Settings live in one global tree ``root.*``; reading a missing attribute
creates a sub-tree, so a config file can write ``root.mnist_tpu.
learning_rate = 0.01`` without declarations.  The defaults under
``root.common`` are the reference's keys and values (its
``veles_tpu/config.py`` documents each); the samples read their own
``root.<sample>_tpu`` subtrees with the reference's defaults.

Layered overrides: package defaults → ``/etc/default/veles_tpu_torch``
→ ``~/.veles_tpu_torch`` → ``$PWD/site_config.py`` → the per-run config
file → ``-c "root.x = y"`` snippets on the command line.

:class:`Range` and :class:`Choice` mark tuneables in a config written
for the genetic optimizer (``--optimize``, :mod:`veles_tpu_torch.
genetics`), which draws and mutates them; :func:`fix_config` replaces
them by their defaults, so such a config runs standalone.
"""

import os
import runpy
from pathlib import Path

import numpy


class Config:
    """A node in the config tree.  Attribute access autovivifies sub-trees."""

    def __init__(self, path="root"):
        object.__setattr__(self, "_path_", path)
        object.__setattr__(self, "_protected_", set())

    # -- tree behaviour ---------------------------------------------------

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self._path_, name))
        object.__setattr__(self, name, child)
        return child

    def __setattr__(self, name, value):
        if name in self._protected_:
            raise AttributeError(
                "config key %s.%s is protected" % (self._path_, name))
        object.__setattr__(self, name, value)

    def protect(self, *names):
        """Mark keys read-only."""
        self._protected_.update(names)

    def update(self, value):
        """Deep-merge a dict (or another Config) into this node."""
        if isinstance(value, Config):
            value = value.__content__()
        if not isinstance(value, dict):
            raise TypeError("Config.update() needs a dict, got %r" % (value,))
        for k, v in value.items():
            if k in self._protected_:
                raise AttributeError(
                    "config key %s.%s is protected" % (self._path_, k))
            if isinstance(v, dict):
                cur = vars(self).get(k)
                if not isinstance(cur, Config):
                    # a dict merge over a plain leaf replaces it with
                    # a fresh subtree (instead of crashing on
                    # None.update) — seeded from the leaf's own keys
                    # when the leaf was a plain dict, so layered
                    # overrides still MERGE rather than discard
                    node = Config("%s.%s" % (self._path_, k))
                    object.__setattr__(self, k, node)
                    if isinstance(cur, dict):
                        node.update(cur)
                getattr(self, k).update(v)
            else:
                setattr(self, k, v)
        return self

    def __content__(self):
        """The tree below this node as a plain nested dict."""
        out = {}
        for k, v in vars(self).items():
            if k.startswith("_") and k.endswith("_"):
                continue
            out[k] = v.__content__() if isinstance(v, Config) else v
        return out

    def get(self, name, default=None):
        """Read a key without autovivifying; Config-valued (unset) → default."""
        v = vars(self).get(name, default)
        return default if isinstance(v, Config) else v

    def get_dict(self, name, default=None):
        """Read a dict-valued key without autovivifying.  ``update``
        stores nested dicts AS subtrees, so plain ``get`` can't see
        them; this returns the subtree's content, a plain dict value,
        or ``default`` (for unset/None/empty)."""
        v = vars(self).get(name)
        if isinstance(v, Config):
            v = v.__content__()
        return dict(v) if v else default

    def __contains__(self, name):
        v = vars(self).get(name)
        return v is not None and not isinstance(v, Config)

    def __bool__(self):
        # An autovivified (empty) node is falsy so `if root.x.y:` is safe.
        return bool(self.__content__())

    def __iter__(self):
        return iter(self.__content__().items())

    def __repr__(self):
        return "Config(%s: %r)" % (self._path_, self.__content__())

    def print_(self, indent=0, file=None):
        import sys
        file = file or sys.stdout
        for k, v in sorted(vars(self).items()):
            if k.startswith("_") and k.endswith("_"):
                continue
            if isinstance(v, Config):
                print("  " * indent + k + ":", file=file)
                v.print_(indent + 1, file)
            else:
                print("  " * indent + "%s: %r" % (k, v), file=file)


#: The global configuration tree.
root = Config("root")

# -- package defaults: the reference's keys and values -----------------------

root.common.update({
    "dirs": {
        "cache": os.path.join(
            os.environ.get("XDG_CACHE_HOME", str(Path.home() / ".cache")),
            "veles_tpu_torch"),
        "snapshots": os.path.join(os.getcwd(), "snapshots"),
        "datasets": os.environ.get(
            "VELES_TPU_DATA", os.path.join(os.getcwd(), "data")),
    },
    "precision": {
        "compute_dtype": "bfloat16",
        "accum_dtype": "float32",
        "param_dtype": "float32",
        "level": 0,
    },
    "engine": {
        "backend": os.environ.get("VELES_TPU_BACKEND", "auto"),
        "eager": False,
        "fuse": True,
    },
    "timings": False,
    "mesh": None,
    "snapshot_suffix": "",
    "ensemble_train_ratio": None,
    "trace": {"run": False, "profiler_dir": None,
              "compilation_cache_dir": None},
    "loader": {"prefetch": {"enabled": True, "depth": 2}},
    "api": {"max_steps": 2048, "max_batch": 64, "admin_token": None,
            "model_id": "veles-lm"},
    "router": {
        "health_interval": 0.5,
        "health_timeout": 1.0,
        "breaker_failures": 3,
        "breaker_cooldown": 2.0,
        "retries": 3,
        "retry_delay": 0.05,
        "retry_cap": 2.0,
        "hedge_delay": 0.0,
        "affinity_tokens": 16,
        "request_timeout": None,
        "shed_retry_after": 2,
        "prefix_routing": True,
        "prefix_fetch": True,
        "prefix_fetch_min": 2,
    },
    "telemetry": {"enabled": True, "cost_analysis": True},
    "health": {
        "enabled": True,
        "policy": "warn",
        "grad_norm_max": None,
        "sync_every": 1,
        "ema_beta": 0.9,
        "divergence_tolerance": 1.5,
        "divergence_patience": 3,
    },
    "flightrec": {"enabled": True, "dir": None, "dump_on_exit": False},
    "alerts": {
        "enabled": True,
        "interval": 1.0,
        "defaults": True,
        "rules": (),
        "webhook_url": None,
    },
    "reqtrace": {"enabled": True},
    "slo": {
        "enabled": True,
        "target": 0.99,
        "windows": (60.0, 300.0, 3600.0),
        "ttft_ms": {"low": 5000.0, "normal": 2000.0, "high": 500.0},
        "e2e_ms": {"low": 120000.0, "normal": 60000.0,
                   "high": 30000.0},
    },
    "serving": {
        "tp": 0,
        "role": "both",
        "kv": "paged",
        "block_size": 16,
        "kv_blocks": None,
        "kv_dtype": "fp32",
        "fused_verify": False,
        "prefill_chunk": 64,
        "warm_buckets": True,
        "request_timeout": 120.0,
        "watchdog": 300.0,
        "shed_block_factor": 4.0,
        "spec": True,
        "spec_k": 4,
        "prefix_cache": True,
        "prefix_evict": True,
        "kv_host_bytes": 0,
        "kv_export_bytes": 256 << 20,
        "drafter": "ngram",
        "draft_k_min": 1,
        "draft_ema": 0.5,
        "draft_shrink": 0.5,
        "draft_grow": 0.8,
        "tp_overlap": False,
    },
    "fleet": {"rebalance": True},
    "controller": {
        "enabled": False,
        "interval": 2.0,
        "min_replicas": 1,
        "max_replicas": 4,
        "scale_up_cooldown": 10.0,
        "scale_down_cooldown": 30.0,
        "quiet_ticks": 5,
        "queue_high": 4.0,
        "occupancy_low": 0.3,
        "role_deadband": 0.25,
        "kv_pressure_high": 0.85,
        "kv_pressure_low": 0.5,
        "shed_step": 0.5,
        "shed_min": 1.0,
        "shed_max": 8.0,
        "audit_keep": 256,
        "history_window": 30.0,
    },
    "tenant": {
        "enabled": False,
        "rate": 0.0,
        "burst": 0.0,
        "max_concurrent": 0,
        "label_cardinality": 8,
    },
    "tsdb": {
        "enabled": True,
        "tiers": ((1.0, 600.0), (10.0, 3600.0), (60.0, 86400.0)),
        "max_series": 512,
        "max_bytes": 16 << 20,
        "metering": True,
    },
    "faults": {"spec": ""},
    "web": {"host": "localhost", "port": 8090, "status_url": None},
    "graphics": {"enabled": False, "port": 0},
    "publishing": {"confluence": {}},
})
root.common.protect("dirs")


# -- tuneable markers (the reference's genetics/core.py) --------------------

class Tuneable:
    """Base marker placed in the config tree: the search space of the
    genetic optimizer (:mod:`veles_tpu_torch.genetics`)."""

    def __init__(self, default):
        self.default = default

    def random(self, rng):
        raise NotImplementedError()

    def mutate(self, value, rng, scale):
        raise NotImplementedError()

    def clip(self, value):
        return value


class Range(Tuneable):
    """Numeric tuneable in [min_value, max_value]."""

    def __init__(self, default, min_value, max_value):
        super(Range, self).__init__(default)
        self.min_value = min_value
        self.max_value = max_value
        self._integer = all(
            isinstance(v, (int, numpy.integer)) and not isinstance(v, bool)
            for v in (default, min_value, max_value))

    def clip(self, value):
        value = min(max(value, self.min_value), self.max_value)
        return int(round(value)) if self._integer else float(value)

    def random(self, rng):
        return self.clip(rng.uniform(self.min_value, self.max_value))

    def mutate(self, value, rng, scale):
        span = (self.max_value - self.min_value) * scale
        return self.clip(value + rng.normal(0.0, max(span, 1e-12)))

    def __repr__(self):
        return "Range(%r, %r, %r)" % (self.default, self.min_value,
                                      self.max_value)


class Choice(Tuneable):
    """Categorical tuneable."""

    def __init__(self, default, choices):
        super(Choice, self).__init__(default)
        self.choices = list(choices)

    def random(self, rng):
        return self.choices[int(rng.integers(len(self.choices)))]

    def mutate(self, value, rng, scale):
        if rng.random() < max(scale, 0.1):
            return self.random(rng)
        return value


def fix_config(cfg):
    """Replace remaining Tuneable markers with their defaults so a
    workflow can run un-tuned."""
    for k, v in list(vars(cfg).items()):
        if k.startswith("_") and k.endswith("_"):
            continue
        if isinstance(v, Config):
            fix_config(v)
        elif isinstance(v, Tuneable):
            setattr(cfg, k, v.default)


def _exec_globals():
    return {"root": root, "Config": Config, "Range": Range,
            "Choice": Choice}


def apply_config_file(path, extra_globals=None):
    """Execute a per-run config file: plain Python mutating ``root``."""
    g = _exec_globals()
    if extra_globals:
        g.update(extra_globals)
    runpy.run_path(path, init_globals=g)


def apply_override(snippet):
    """Apply a ``-c "root.x.y = z"`` command-line override."""
    exec(snippet, _exec_globals())


#: the layered site files, in the order they apply
SITE_CONFIGS = ("/etc/default/veles_tpu_torch",
                str(Path.home() / ".veles_tpu_torch"),
                os.path.join(os.getcwd(), "site_config.py"))


def load_site_configs():
    """Merge the layered site overrides (:data:`SITE_CONFIGS`)."""
    for p in SITE_CONFIGS:
        if os.path.isfile(p):
            try:
                runpy.run_path(p, init_globals={"root": root})
            except Exception:  # site files must never break startup
                import logging
                logging.getLogger("config").exception(
                    "failed to apply site config %s", p)


def get(cfg, default=None):
    """``get(root.x.y, default)`` — unset (Config) values become default."""
    return default if isinstance(cfg, Config) else cfg
