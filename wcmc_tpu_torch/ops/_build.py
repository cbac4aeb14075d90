"""Build and load the hand-written CUDA kernels under ``ops/csrc``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object with a plain C
interface; the objects are linked into one shared library that is
loaded with ``ctypes``.  The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale build is
never loaded.  The build goes to ``build/kernels`` at the repository
root at first use; nothing is compiled when a module is imported.
Processes that build at once each compile into their own object
directory and temporary library, and only the finished files are
renamed into place, so none loads another's half-written output.

Launch accounting: ``launches[name]`` counts the launches of each hand
kernel (incremented by its wrapper right after a launch), and
``plain_calls[name]`` counts calls of its plain PyTorch version, so a
run can show that a path went through the kernels and never through
their plain versions.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()
plain_calls: collections.Counter = collections.Counter()


def reset_counts():
    launches.clear()
    plain_calls.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> dict:
    """Compile and link the kernel library (once per process; reused
    from ``build/kernels`` when the sources are unchanged).

    Returns ``{"path", "seconds", "ptxas"}``: the library, the wall time
    of this build (0 for a reused one) and nvcc's ``-Xptxas -v`` report
    (registers, shared memory and spills per kernel)."""
    sources = sorted(CSRC.glob("*.cu"))
    tag = _digest(sorted(CSRC.glob("*.cu*")))
    lib = BUILD_DIR / f"libwcmc_kernels_{tag}.so"
    log = lib.with_suffix(".log")
    if lib.is_file() and log.is_file():
        return {"path": str(lib), "seconds": 0.0, "ptxas": log.read_text()}

    obj_dir = BUILD_DIR / f"{tag}.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        reports.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(reports))
    tmp = obj_dir / lib.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + link.stdout)
    ptxas = "\n".join(reports)
    (obj_dir / log.name).write_text(ptxas)
    # the log first: a library is taken as built once both exist
    os.replace(obj_dir / log.name, log)
    os.replace(tmp, lib)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "ptxas": ptxas}


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    lib.wcmc_error_string.argtypes = [ctypes.c_int]
    lib.wcmc_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def kernel(name: str, *argtypes):
    """The C entry point ``name`` with its argument types declared
    (pointers and the stream as ``c_void_p``)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str):
    if err != 0:
        msg = library().wcmc_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


@functools.cache
def sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
