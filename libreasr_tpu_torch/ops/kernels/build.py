"""Builds the port's native sources into shared libraries at first use.

Each source `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into
`build/lib<name>-<hash>.so` (a plain C interface, loaded with ctypes).
Host sources `csrc/<name>.cpp` (the BPE trainer, the audio codecs) are
compiled the same way by HOST_CXX, the g++ on the PATH (nvcc's host
compiler), with CXX_FLAGS and HOST_LIBS, and need no nvcc: `load_host`. `$CXX` is not read: a
compiler whose C++ runtime is not the one the process has loaded gives a
library that crashes in it (seen with a second GCC install that `$CXX`
named on an H100 host).

The hash covers the source (a .cu also every header `csrc/*.cuh`), the
flags and the compiler: its resolved path and what it reports of its
version and target. So an edited source or header, or a library that
another toolchain built, is never served as current. Builds of several
sources run in parallel. A failed build raises; nothing falls back to
the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-Wall"]
# libraries a host source links, after the source (the codecs dlopen
# the host's codec libraries)
HOST_LIBS = {"audio_codecs": ["-ldl"]}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",  # the toolkit's default install prefix
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("libreasr_tpu_torch: nvcc not found (set CUDA_HOME)")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


@functools.lru_cache(maxsize=None)
def compiler_identity(compiler: str) -> str:
    """The compiler's resolved path and its own account of its version
    and target (`--version` for nvcc, `-dumpfullversion -dumpmachine` for
    g++). A compiler that cannot be run is named as given: its build
    then fails and raises."""
    path = shutil.which(compiler) or compiler
    args = ["--version"] if os.path.basename(path) == "nvcc" else [
        "-dumpfullversion", "-dumpmachine"]
    try:
        proc = subprocess.run([path, *args], capture_output=True, text=True)
    except OSError:
        return compiler
    return f"{os.path.realpath(path)}\n{proc.stdout}"


def _library_path(name: str, sources: list[str], compiler: str,
                  flags: list[str]) -> str:
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(compiler_identity(compiler).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    try:
        nvcc = find_nvcc()
    except RuntimeError:
        nvcc = "nvcc"  # named as given: `build` raises for it
    return _library_path(name, [source_path(name)]
                         + [os.path.join(CSRC_DIR, f) for f in headers],
                         nvcc, NVCC_FLAGS)


def host_library_path(name: str) -> str:
    return _library_path(name, [os.path.join(CSRC_DIR, f"{name}.cpp")],
                         HOST_CXX, CXX_FLAGS + HOST_LIBS.get(name, []))


def _compile(jobs: dict[str, tuple[list[str], str]], what: str) -> dict[str, float]:
    """Starts every job {name: (command, library)} at once, each writing
    a temporary file (`-o` is appended) that replaces its library when
    the command succeeds; the compiler's output is kept beside each
    library as .log. Returns {name: seconds}. Any failure raises with
    the compiler's output, once every command has ended."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, failed = {}, []
    for name, (cmd, out) in jobs.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            proc = subprocess.Popen([*cmd, "-o", tmp], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            failed.append(f"{what} build of {name} failed: {e}")
            continue
        procs[name] = (proc, tmp, out, time.perf_counter())
    seconds = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(out[: -len(".so")] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{what} build of {name} failed "
                          f"({os.path.basename(proc.args[0])} exit "
                          f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("libreasr_tpu_torch: " + "\n".join(failed))
    return seconds


def build(names) -> dict[str, float]:
    """Compile every CUDA source in `names` that has no current library,
    all at once. Returns {name: seconds} for the sources it compiled; the
    compiler's resource report is kept beside each library as .log."""
    nvcc = find_nvcc()
    jobs = {name: ([nvcc, *NVCC_FLAGS, source_path(name)], library_path(name))
            for name in names}
    return _compile({k: v for k, v in jobs.items() if not os.path.exists(v[1])},
                    "kernel")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device: the launch plans of
    kernels E and H size their grids by it."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _load(name: str, path_fn, build_fn) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = path_fn(name)
            if not os.path.exists(out):
                build_fn(name)
            lib = ctypes.CDLL(out)
            _libs[name] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of the CUDA source csrc/<name>.cu, built first
    if it has no current library."""
    return _load(name, library_path, lambda n: build([n]))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source csrc/<name>.cpp, compiled
    first if it has no current library. A failed build raises with the
    compiler's output."""
    def build_host(n):
        src = os.path.join(CSRC_DIR, f"{n}.cpp")
        _compile({n: ([HOST_CXX, *CXX_FLAGS, src, *HOST_LIBS.get(n, [])],
                      host_library_path(n))}, "host")

    return _load(name, host_library_path, build_host)
