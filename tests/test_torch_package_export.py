"""Inference packages of the PyTorch port (``veles_tpu_torch/
package_export.py``) held against the JAX package's on the CPU (the
oracle is ``tests/test_package_export.py``), float32 compute on both
sides:

- an archive the port writes from a JAX chain's weights (carried by
  ``convert.params_from_numpy``) has the JAX archive's ``contents.json``
  but for ``checksum`` (each package digests its own source) and
  ``stablehlo`` (the port writes none), and byte-equal ``.npy`` files;
- each package's archive loads in the other's ``load_package`` and
  runs "python" mode to the JAX chain's outputs;
- the port's "python" mode equals its chain, pads a partial batch and
  squeezes a single sample, reproduces its logits in a fresh process
  that imports no JAX, and refuses "stablehlo" on both archives;
- the C++ runner of ``runtime/`` (built from a copy in a temporary
  directory) runs the port's archives: MLP, convolutional, transposed,
  grouped convolution with LRN, a mini AlexNet, MoE, the LM head,
  greedy and sampled generation, transformers with dense and MoE FFNs,
  each within the oracle's tolerance of the port's "python" mode."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tarfile

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNTIME_DIR = os.path.join(REPO, "runtime")
TOL = dict(rtol=1e-5, atol=1e-5)


@contextlib.contextmanager
def f32(root):
    """``root``'s compute dtype (what each package's ``load_package``
    builds its units in) float32, restored after."""
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    try:
        yield
    finally:
        root.common.precision.compute_dtype = saved


def jax_f32():
    from veles_tpu.config import root
    return f32(root)


@pytest.fixture(autouse=True)
def port_f32():
    from veles_tpu_torch.config import root
    with f32(root):
        yield


def _tokens(rng, vocab, shape):
    return rng.integers(0, vocab, shape).astype(numpy.float32)


def _alexnet_mini():
    from veles_tpu_torch.samples.alexnet import alexnet_layers
    return alexnet_layers(classes=7, space_to_depth=0)


#: name → (layer spec, input maker, input shape): the oracle's chains
CHAINS = {
    "mlp": (lambda: [
        {"type": "all2all_tanh", "output_sample_shape": (8,)},
        {"type": "softmax", "output_sample_shape": (4,)}],
        lambda rng: rng.normal(size=(16, 20)).astype(numpy.float32)),
    "grouped_conv_lrn": (lambda: [
        {"type": "conv_relu", "n_kernels": 8, "kx": 3, "ky": 3,
         "sliding": (2, 2), "padding": "same", "n_groups": 2},
        {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "softmax", "output_sample_shape": (5,)}],
        lambda rng: rng.normal(size=(4, 9, 9, 4)).astype(numpy.float32)),
    "deconv_same": (lambda: [
        {"type": "deconv", "n_kernels": 4, "kx": 3, "ky": 3,
         "sliding": (2, 2), "padding": "same"}],
        lambda rng: rng.normal(size=(2, 5, 6, 3)).astype(numpy.float32)),
    "deconv_valid": (lambda: [
        {"type": "deconv", "n_kernels": 4, "kx": 3, "ky": 3,
         "sliding": (2, 2), "padding": "valid"}],
        lambda rng: rng.normal(size=(2, 5, 6, 3)).astype(numpy.float32)),
    "alexnet_mini": (_alexnet_mini,
                     lambda rng: rng.random((2, 67, 67, 3)).astype(
                         numpy.float32)),
    "moe": (lambda: [
        {"type": "moe", "n_experts": 4, "top_k": 2, "hidden": 12},
        {"type": "softmax", "output_sample_shape": (5,)}],
        lambda rng: rng.normal(size=(6, 10)).astype(numpy.float32)),
    "transformer": (lambda: [
        {"type": "embedding", "vocab": 12, "dim": 32},
        {"type": "transformer_block", "heads": 4, "n_experts": 2,
         "top_k": 1},
        {"type": "mean_pool_seq"},
        {"type": "softmax", "output_sample_shape": (12,)}],
        lambda rng: _tokens(rng, 12, (4, 16))),
    "lm_head": (lambda: [
        {"type": "embedding", "vocab": 13, "dim": 16},
        {"type": "transformer_block", "heads": 2, "hidden": 24,
         "causal": True},
        {"type": "token_logits", "vocab": 13}],
        lambda rng: _tokens(rng, 13, (3, 12))),
    "attention_v2": (lambda: [
        {"type": "attention", "heads": 2, "block_size": 4}],
        lambda rng: rng.normal(size=(2, 8, 16)).astype(numpy.float32)),
}


def jax_chain(spec, x):
    """The JAX package's chain for ``spec`` over input ``x``, filled by
    its own generators (their state kept)."""
    from veles_tpu import prng
    from veles_tpu.accelerated_units import AcceleratedWorkflow
    from veles_tpu.backends import Device
    from veles_tpu.memory import Array
    from veles_tpu.models.standard import make_forwards
    sample = x.astype(numpy.int32) if any(
        s["type"] == "embedding" for s in spec) else x
    with prng.get().preserve_state():
        wf = AcceleratedWorkflow(None, name="pkg")
        units = make_forwards(wf, Array(sample), spec)
        dev = Device(backend="numpy")
        for u in units:
            u.initialize(device=dev)
    return units


def jax_params(units):
    return {i: {n: numpy.array(a.map_read().mem)
                for n, a in u.param_arrays().items()}
            for i, u in enumerate(units)}


def jax_forward(units, x):
    import jax.numpy as jnp
    h = jnp.asarray(x)
    for u in units:
        h = u.apply({k: jnp.asarray(a.map_read().mem)
                     for k, a in u.param_arrays().items()}, h)
    return numpy.asarray(h)


def port_forward(chain, x):
    with torch.no_grad():
        h = torch.as_tensor(x)
        for u in chain:
            h = u.apply(h)
    return h.float().numpy()


def read_archive(path):
    with tarfile.open(path, "r:gz") as tar:
        files = {m.name: tar.extractfile(m).read()
                 for m in tar.getmembers() if m.isfile()}
    return json.loads(files.pop("contents.json")), files


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """name → (JAX units, port chain, x, JAX archive, port archive, the
    JAX chain's outputs), the port's chain carrying the JAX weights."""
    from veles_tpu.package_export import export_package as jax_export
    from veles_tpu_torch.convert import params_from_numpy
    from veles_tpu_torch.package_export import export_package
    out = {}
    tmp = tmp_path_factory.mktemp("pkg")
    with jax_f32():
        for i, (name, (spec_of, make_x)) in enumerate(sorted(
                CHAINS.items())):
            x = make_x(numpy.random.default_rng(100 + i))
            units = jax_chain(spec_of(), x)
            chain = params_from_numpy(spec_of(), jax_params(units),
                                      device="cpu", dtype="float32")
            jpath, ppath = str(tmp / (name + ".jax.tar.gz")), \
                str(tmp / (name + ".port.tar.gz"))
            jax_export(units, jpath, x.shape, name=name)
            export_package(chain, ppath, x.shape, name=name)
            out[name] = (units, chain, x, jpath, ppath,
                         jax_forward(units, x))
    return out


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_contents_match_reference(packages, name):
    """The same manifest but for ``checksum`` and ``stablehlo``, the same
    files but ``forward.shlo``, byte-equal ``.npy`` files."""
    _, _, _, jpath, ppath, _ = packages[name]
    jman, jfiles = read_archive(jpath)
    pman, pfiles = read_archive(ppath)
    assert pman["stablehlo"] is None
    assert jman["stablehlo"] in (None, "forward.shlo")
    for m in (jman, pman):
        m.pop("checksum")
        m.pop("stablehlo")
    assert pman == jman
    jfiles.pop("forward.shlo", None)
    assert sorted(pfiles) == sorted(jfiles)
    for f in jfiles:
        assert pfiles[f] == jfiles[f], f


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_each_package_loads_in_the_other(packages, name):
    """The port's archive in the JAX ``load_package`` and the JAX
    archive in the port's, both in "python" mode, give the JAX chain's
    outputs."""
    from veles_tpu.package_export import load_package as jax_load
    from veles_tpu_torch.package_export import load_package
    _, _, x, jpath, ppath, want = packages[name]
    with jax_f32():
        got_jax = jax_load(ppath).run(x, mode="python")
    got_port = load_package(jpath, device="cpu").run(x)
    numpy.testing.assert_allclose(got_jax, want, **TOL)
    numpy.testing.assert_allclose(got_port, want, **TOL)


def test_python_roundtrip_exact(packages):
    """The port's archive reloaded gives its chain's outputs bit for
    bit, whichever package's class id names a unit."""
    from veles_tpu_torch.package_export import load_package
    _, chain, x, _, ppath, _ = packages["mlp"]
    pkg = load_package(ppath, device="cpu")
    numpy.testing.assert_array_equal(pkg.run(x, mode="python"),
                                     port_forward(chain, x))
    assert [u.name for u in pkg.units] == ["all2all_tanh0", "softmax1"]


def test_partial_batch_padding(packages):
    from veles_tpu_torch.package_export import load_package
    _, chain, x, _, ppath, _ = packages["mlp"]
    pkg = load_package(ppath, device="cpu")
    want = port_forward(chain, x)
    numpy.testing.assert_array_equal(pkg.run(x[:3]), want[:3])
    numpy.testing.assert_array_equal(pkg.run(x[0]), want[0])
    with pytest.raises(ValueError, match="exceeds"):
        pkg.run(numpy.concatenate([x, x]))


def test_fresh_process_golden(packages, tmp_path):
    """A process that imports neither JAX nor the workflow's module
    reproduces the logits from the archive alone."""
    _, chain, x, _, ppath, _ = packages["mlp"]
    numpy.save(tmp_path / "x.npy", x)
    numpy.save(tmp_path / "y_ref.npy", port_forward(chain, x))
    code = (
        "import numpy, sys\n"
        "from veles_tpu_torch.config import root\n"
        "from veles_tpu_torch.package_export import load_package\n"
        "root.common.precision.compute_dtype = 'float32'\n"
        "pkg = load_package(sys.argv[1], device='cpu')\n"
        "y = pkg.run(numpy.load(sys.argv[2]), mode='python')\n"
        "numpy.testing.assert_array_equal(y, numpy.load(sys.argv[3]))\n"
        "assert 'jax' not in sys.modules and 'veles_tpu' not in "
        "sys.modules\n"
        "print('GOLDEN-OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", code, ppath, str(tmp_path / "x.npy"),
         str(tmp_path / "y_ref.npy")],
        capture_output=True, text=True, env=env, timeout=120)
    assert "GOLDEN-OK" in r.stdout, r.stderr[-800:]


def test_stablehlo_mode_raises(packages):
    """The port runs no serialized program: "stablehlo" raises on its
    archive and on the JAX package's, which carries one, and says why;
    "python" still runs the JAX archive."""
    from veles_tpu_torch.package_export import load_package
    _, _, x, jpath, ppath, _ = packages["mlp"]
    _, jfiles = read_archive(jpath)
    assert "forward.shlo" in jfiles
    for path in (jpath, ppath):
        pkg = load_package(path, device="cpu")
        with pytest.raises(RuntimeError, match="forward.shlo"):
            pkg.run(x, mode="stablehlo")
        assert pkg.run(x).shape == (16, 4)


def test_plain_packages_stay_v1(packages):
    """A package without v2 keys is stamped format 1; one whose config
    uses them (attention's ``block_size``) format 2, in both packages."""
    for name, version in (("mlp", 1), ("transformer", 1),
                          ("attention_v2", 2)):
        for path in packages[name][3:5]:
            assert read_archive(path)[0]["format_version"] == version


def test_workflow_package_export(tmp_path):
    """``Workflow.package_export`` of the CIFAR sample: the input spec
    from the initialized loader's minibatch (``batch`` replacing its
    size), the JAX workflow's manifest but for ``checksum`` and
    ``stablehlo``, and the archive reloaded equal to the chain."""
    from veles_tpu.backends import Device
    from veles_tpu.samples.cifar import CifarWorkflow as JaxCifar
    from veles_tpu_torch.package_export import load_package
    from veles_tpu_torch.samples.cifar import CifarWorkflow
    from tests.test_torch_workflow import jax_state
    keys = dict(synthetic_train=64, synthetic_valid=32, minibatch_size=16)
    with jax_state("cifar_tpu", tmp_path / "jax", max_epochs=1,
                   snapshot_time_interval=1e9, **keys):
        jwf = JaxCifar(None, plotters=False)
        jwf.initialize(device=Device(backend="numpy"))
        jwf.package_export(str(tmp_path / "jax.tar.gz"), batch=8)
    wf = CifarWorkflow(dtype="float32", max_epochs=1,
                       snapshotter_config={"enabled": False}, **keys)
    wf.initialize(device="cpu")
    path = wf.package_export(str(tmp_path / "port.tar.gz"), batch=8)
    jman, _ = read_archive(str(tmp_path / "jax.tar.gz"))
    pman, _ = read_archive(path)
    assert pman["checksum"] == wf.checksum() != jman["checksum"]
    for m in (jman, pman):
        m.pop("checksum")
        m.pop("stablehlo")
    assert pman == jman
    assert pman["input"] == {"shape": [8, 32, 32, 3], "dtype": "float32"}
    x = numpy.asarray(wf.loader.original_data[:8], numpy.float32)
    numpy.testing.assert_array_equal(
        load_package(path, device="cpu").run(x),
        port_forward(wf.forwards, x))
    wf.stop()


def test_mnist_forward_reads_a_package(packages, capsys):
    """``samples/mnist_forward.py`` reads an archive (random inputs of
    the packaged shape, as the reference's)."""
    from veles_tpu_torch.samples import mnist_forward
    _, _, _, _, ppath, _ = packages["mlp"]
    probs = mnist_forward.forward_from_package(ppath, 5, device="cpu")
    assert probs.shape == (5, 4)
    numpy.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-2)
    assert mnist_forward.main([ppath, "3", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("sample ") == 3


# -- the C++ runner -------------------------------------------------------------

@pytest.fixture(scope="session")
def runner_binary(tmp_path_factory):
    """``runtime/`` built in a temporary copy, so nothing is written
    under the repository; skipped only if ``make`` fails."""
    src = tmp_path_factory.mktemp("runtime")
    for f in os.listdir(RUNTIME_DIR):
        if f.endswith((".cc", ".h")) or f == "Makefile":
            shutil.copy(os.path.join(RUNTIME_DIR, f), src)
    binary = str(src / "veles_runner")
    r = subprocess.run(["make", "-j4", "-C", str(src)],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0 or not os.path.exists(binary):
        pytest.skip("C++ runner build failed: %s" % r.stderr[-400:])
    return binary


def run_runner(binary, path, x, tmp_path, *extra):
    numpy.save(tmp_path / "in.npy", x)
    out = str(tmp_path / "out.npy")
    r = subprocess.run([binary, path, str(tmp_path / "in.npy"), out]
                       + list(extra), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout), numpy.load(out)


def _python_mode(path, x):
    from veles_tpu_torch.package_export import load_package
    return load_package(path, device="cpu").run(x)


@pytest.mark.parametrize("name,atol", [
    ("mlp", 5e-3), ("grouped_conv_lrn", 2e-2), ("deconv_same", 2e-2),
    ("deconv_valid", 2e-2), ("alexnet_mini", 2e-2), ("moe", 2e-3),
    ("lm_head", 2e-3)])
def test_cpp_runner_matches_python_mode(packages, runner_binary, tmp_path,
                                        name, atol):
    """The runner on the port's archive against its "python" mode, at
    the oracle's tolerance for the chain."""
    _, chain, x, _, ppath, _ = packages[name]
    status, y = run_runner(runner_binary, ppath, x, tmp_path)
    assert status["units"] == len(chain)
    want = _python_mode(ppath, x)
    assert y.shape == want.shape
    numpy.testing.assert_allclose(y, want, atol=atol)
    if name in ("mlp", "alexnet_mini", "moe", "grouped_conv_lrn"):
        assert numpy.all(abs(y.sum(axis=1) - 1.0) < 1e-3)


def test_cpp_runner_workflow_package(runner_binary, tmp_path):
    """A CIFAR workflow's ``package_export`` through the runner (the
    oracle's ``conv_package``)."""
    from veles_tpu_torch.samples.cifar import CifarWorkflow
    wf = CifarWorkflow(dtype="float32", synthetic_train=64,
                       synthetic_valid=32, minibatch_size=16,
                       snapshotter_config={"enabled": False})
    wf.initialize(device="cpu")
    path = wf.package_export(str(tmp_path / "cifar.tar.gz"), batch=8)
    x = numpy.asarray(wf.loader.original_data[:8], numpy.float32)
    _, y = run_runner(runner_binary, path, x, tmp_path)
    numpy.testing.assert_allclose(y, _python_mode(path, x), atol=2e-2)
    assert numpy.all(abs(y.sum(axis=1) - 1.0) < 1e-3)
    wf.stop()


def _lm_chain(vocab, window, seed):
    from veles_tpu_torch.convert import init_params
    spec = [{"type": "embedding", "vocab": vocab, "dim": 16},
            {"type": "transformer_block", "heads": 2, "hidden": 24,
             "causal": True},
            {"type": "token_logits", "vocab": vocab}]
    return init_params(spec, seed, window=window, device="cpu",
                       dtype="float32")


def test_cpp_runner_generate_greedy_parity(runner_binary, tmp_path):
    """The runner's ``--generate`` decode, through its K/V caches,
    equals the port's greedy ``generate`` token for token when the
    packaged window is prompt + steps."""
    from veles_tpu_torch.models.generate import generate
    from veles_tpu_torch.package_export import export_package
    prompt_len, steps, window = 5, 7, 12
    chain = _lm_chain(19, window, 17)
    prompt = numpy.random.default_rng(17).integers(
        1, 19, (2, prompt_len)).astype(numpy.int32)
    want = generate(chain, torch.as_tensor(prompt), steps)
    path = export_package(chain, str(tmp_path / "gen.tar.gz"), (2, window),
                          name="gen")
    status, y = run_runner(runner_binary, path, prompt.astype(
        numpy.float32), tmp_path, "--generate", str(steps))
    assert status["generated"] == steps and status["kv_cache"] is True
    assert y.shape == (2, prompt_len + steps)
    numpy.testing.assert_array_equal(y.astype(numpy.int32),
                                     numpy.asarray(want))


def test_cpp_runner_generate_sampling(runner_binary, tmp_path):
    """Sampled decode of the port's archive: deterministic per seed, in
    the vocabulary, the prompt kept, ``--top-k 1`` greedy, ``--top-k``
    without a temperature refused, ``--stop`` freezing a row."""
    from veles_tpu_torch.package_export import export_package
    chain = _lm_chain(15, 12, 8)
    prompt = numpy.random.default_rng(8).integers(
        1, 15, (2, 4)).astype(numpy.float32)
    path = export_package(chain, str(tmp_path / "gs.tar.gz"), (2, 12),
                          name="gs")

    def decode(*extra):
        return run_runner(runner_binary, path, prompt, tmp_path,
                          "--generate", "8", *extra)[1].astype(numpy.int32)

    greedy = decode()
    sampled = ("--temperature", "0.9", "--top-k", "5", "--seed", "11")
    a, b = decode(*sampled), decode(*sampled)
    numpy.testing.assert_array_equal(a, b)
    assert a.shape == (2, 12) and (a >= 0).all() and (a < 15).all()
    numpy.testing.assert_array_equal(a[:, :4], prompt.astype(numpy.int32))
    numpy.testing.assert_array_equal(
        decode("--temperature", "5.0", "--top-k", "1"), greedy)
    numpy.save(tmp_path / "in.npy", prompt)
    r = subprocess.run(
        [runner_binary, path, str(tmp_path / "in.npy"),
         str(tmp_path / "out.npy"), "--generate", "4", "--top-k", "5"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "--temperature" in r.stderr
    for ref, extra in ((greedy, ()), (a, sampled)):
        stop_tok = int(ref[0, 5])
        st = decode("--stop", str(stop_tok), *extra)
        for n in range(2):
            hits = numpy.nonzero(ref[n, 4:] == stop_tok)[0]
            expect = ref[n].copy()
            if hits.size:
                expect[4 + int(hits[0]):] = stop_tok
            numpy.testing.assert_array_equal(st[n], expect)


@pytest.mark.parametrize("n_experts", [0, 3])
def test_cpp_runner_transformer(runner_binary, tmp_path, n_experts):
    """Embedding, a pre-LN causal block with a dense or MoE FFN, the
    mean pool and the softmax head through the runner."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.package_export import export_package
    spec = [{"type": "embedding", "vocab": 11, "dim": 16},
            {"type": "transformer_block", "heads": 2, "hidden": 24,
             "causal": True, "n_experts": n_experts,
             "top_k": min(2, n_experts or 2)},
            {"type": "mean_pool_seq"},
            {"type": "softmax", "output_sample_shape": (5,)}]
    chain = init_params(spec, 21, window=10, device="cpu", dtype="float32")
    x = _tokens(numpy.random.default_rng(21), 11, (3, 10))
    path = export_package(chain, str(tmp_path / "trx.tar.gz"), x.shape,
                          name="trx")
    _, y = run_runner(runner_binary, path, x, tmp_path)
    want = _python_mode(path, x)
    assert y.shape == want.shape
    numpy.testing.assert_allclose(y, want, atol=2e-3)
