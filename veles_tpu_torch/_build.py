"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``.cu`` file has a plain C interface and is compiled by its own
``nvcc`` into a shared library, loaded with ``ctypes``; all the
compilers start together, so the build takes as long as the slowest
file (seconds), not their sum.  A source that included PyTorch's
headers would take minutes to compile, which every fresh machine would
pay again.  The wrappers in ``ops/`` pass ``data_ptr()``s and the
current stream; each C entry point returns ``cudaGetLastError()``
right after its launch, and the wrapper raises if that is not 0.

Libraries land in ``veles_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the hash of the sources and the
flags, so an unchanged source is never rebuilt.  Each library a
process loads is counted by
:func:`veles_tpu_torch.telemetry.compile_tracker.record_build`:
``cold`` with the wall of its ``nvcc``, or ``hit`` when it was already
built.  Nothing here runs on import: the CPU tests import every module
of the package.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: library name → its source under csrc/
SOURCES = {
    "paged_attend": "paged_attend.cu",
    "int8_gemm": "int8_gemm.cu",
    "matmul": "matmul.cu",
    "flash_attention": "flash_attention.cu",
    "lrn": "lrn.cu",
    "uniform": "uniform.cu",
}
#: headers every source may include (their bytes key the build hash)
HEADERS = ("common.cuh",)

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs = {}
#: the compilers' own reports (``-Xptxas=-v``: registers, shared
#: memory, spills per kernel) by library name
ptxas_reports = {}


def nvcc_path():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc"),) if home else ()) \
            + ("/usr/local/cuda/bin/nvcc",):
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are "
            "built from csrc/ on the machine that has the card")
    return found


def _digest(src):
    h = hashlib.sha256()
    for name in (src,) + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name):
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name,
                                                 _digest(SOURCES[name])))


def build_all():
    """Compile every library that is not built yet (one ``nvcc`` per
    source, all started together) and load them all.  Raises with the
    compiler's output if any build fails."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = {n: _target(n) for n in SOURCES
                if not os.path.exists(_target(n))}
        procs = {}
        seconds = {}
        if todo:
            nvcc = nvcc_path()
            for name, out in todo.items():
                tmp = "%s.%d.tmp" % (out, os.getpid())
                cmd = [nvcc] + NVCC_FLAGS + [
                    "-I", CSRC, "-o", tmp,
                    os.path.join(CSRC, SOURCES[name])]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True), tmp, out)
            t0 = time.perf_counter()
            logs = {}

            def wait(name, proc):
                # each compiler's own wall: they all run at once
                logs[name] = proc.communicate()[0]
                seconds[name] = time.perf_counter() - t0
            waiters = [threading.Thread(target=wait, args=(n, p[0]))
                       for n, p in procs.items()]
            for t in waiters:
                t.start()
            for t in waiters:
                t.join()
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log = logs[name]
            ptxas_reports[name] = log
            if proc.returncode:
                failed.append("%s (nvcc exit %d):\n%s"
                              % (name, proc.returncode, log))
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        from veles_tpu_torch.telemetry.compile_tracker import record_build
        for name in SOURCES:
            if name not in _libs:
                t0 = time.perf_counter()
                _libs[name] = ctypes.CDLL(_target(name))
                record_build(name, seconds.get(
                    name, time.perf_counter() - t0),
                    cached=name not in todo, path=_target(name))
        return dict(_libs)


def library(name):
    """The loaded library ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def check(rc, what):
    """Raise for a nonzero ``cudaError_t`` returned by a C entry."""
    if rc:
        raise RuntimeError("%s failed: CUDA error %d" % (what, rc))
