"""The port's config tree (``veles_tpu_torch/config.py``) held against
the JAX package's: the cases of ``tests/test_config.py`` run on both
``Config`` classes, the default trees equal (but for the cache
directory's package name), the layered site files, ``-c`` snippets,
config files and the tuneable markers."""

import os

import pytest

from veles_tpu.config import Config as JaxConfig, get as jax_get
from veles_tpu_torch import config
from veles_tpu_torch.config import Config, get

pytestmark = pytest.mark.torch_port

BOTH = [pytest.param((Config, get), id="port"),
        pytest.param((JaxConfig, jax_get), id="jax")]


@pytest.mark.parametrize("impl", BOTH)
class TestConfig:
    def test_autovivify(self, impl):
        c = impl[0]("test")
        c.a.b.d = 3
        assert c.a.b.d == 3

    def test_update(self, impl):
        c = impl[0]("test")
        c.update({"x": 1, "sub": {"y": 2}})
        assert c.x == 1 and c.sub.y == 2
        c.update({"sub": {"z": 3}})
        assert c.sub.y == 2 and c.sub.z == 3
        c.leaf = {"a": 1}
        c.update({"leaf": {"b": 2}})
        assert c.leaf.a == 1 and c.leaf.b == 2
        with pytest.raises(TypeError):
            c.update(5)

    def test_content(self, impl):
        c = impl[0]("test")
        c.update({"x": 1, "sub": {"y": 2}})
        assert c.__content__() == {"x": 1, "sub": {"y": 2}}
        assert dict(iter(c)) == {"x": 1, "sub": {"y": 2}}

    def test_protect(self, impl):
        c = impl[0]("test")
        c.k = 1
        c.protect("k")
        with pytest.raises(AttributeError):
            c.k = 2

    def test_protect_blocks_update(self, impl):
        c = impl[0]("test")
        c.sub.x = 1
        c.protect("sub")
        with pytest.raises(AttributeError):
            c.update({"sub": {"x": 99}})
        assert c.sub.x == 1

    def test_bool_empty_falsy(self, impl):
        c = impl[0]("test")
        assert not c.never_set
        c.never_set.leaf = 1
        assert c.never_set

    def test_get_default(self, impl):
        cls, getter = impl
        c = cls("test")
        assert getter(c.missing, 5) == 5
        c.present = 7
        assert getter(c.present, 5) == 7
        assert c.get("present") == 7
        assert c.get("absent", "d") == "d"
        c.sub.y = 1
        assert c.get_dict("sub") == {"y": 1}
        assert c.get_dict("nothing", {}) == {}

    def test_contains(self, impl):
        c = impl[0]("test")
        assert "x" not in c
        c.x = 0
        assert "x" in c


def _strip_cache(tree):
    tree = dict(tree)
    tree["common"] = dict(tree["common"])
    tree["common"]["dirs"] = dict(tree["common"]["dirs"])
    tree["common"]["dirs"].pop("cache")
    return tree


def test_default_tree_equals_the_reference():
    from veles_tpu.config import root as jroot
    mine = Config("root")
    theirs = JaxConfig("root")
    mine.update(config.root.common.__content__())
    theirs.update(jroot.common.__content__())
    got = _strip_cache({"common": mine.__content__()})
    want = _strip_cache({"common": theirs.__content__()})
    # keys other tests may have set at run time are the same in both
    assert got["common"]["serving"] == want["common"]["serving"]
    assert got["common"]["serving"]["kv_dtype"] == "fp32"
    assert sorted(got["common"]) == sorted(want["common"])
    assert config.root.common.dirs.get("cache").endswith(
        "veles_tpu_torch")
    with pytest.raises(AttributeError):
        config.root.common.dirs = {}


def test_config_file_overrides_and_tuneables(tmp_path, monkeypatch):
    from tests.test_torch_cli import restored_process_state
    with restored_process_state():
        path = tmp_path / "cfg.py"
        path.write_text("root.torch_cfg_test.update({'a': 1, "
                        "'lr': Range(0.1, 0.01, 1.0), "
                        "'kind': Choice('x', ['x', 'y'])})\n")
        config.apply_config_file(str(path))
        config.apply_override("root.torch_cfg_test.b = [1, 2]")
        node = config.root.torch_cfg_test
        assert node.a == 1 and node.b == [1, 2]
        assert isinstance(node.lr, config.Range)
        assert node.lr.clip(5) == 1.0 and node.lr.clip(0.5) == 0.5
        assert config.Range(3, 1, 9).clip(4.6) == 5
        config.fix_config(config.root)
        assert node.lr == 0.1 and node.kind == "x"
        # site files: the port's name at home, site_config.py in the cwd
        home = tmp_path / "home"
        home.mkdir()
        (home / ".veles_tpu_torch").write_text(
            "root.torch_cfg_test.site = 'home'\n")
        work = tmp_path / "work"
        work.mkdir()
        (work / "site_config.py").write_text(
            "root.torch_cfg_test.cwd = 'here'\nraise RuntimeError()\n")
        monkeypatch.setattr(config, "SITE_CONFIGS", (
            "/nonexistent/veles_tpu_torch", str(home / ".veles_tpu_torch"),
            str(work / "site_config.py")))
        config.load_site_configs()   # a failing site file only logs
        assert node.site == "home" and node.cwd == "here"
        assert os.path.basename(config.SITE_CONFIGS[1]) == \
            ".veles_tpu_torch"
