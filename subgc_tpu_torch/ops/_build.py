"""Build the port's native sources into shared libraries at first use.

Two kinds of source, both with a plain C interface loaded with ``ctypes``:

* ``csrc/<name>.cu``, the CUDA kernels: compiled with ``nvcc`` for Hopper
  (``sm_90a``), keyed by a hash of every file under ``csrc/`` (a header it
  includes changes the library too) and the flags;
* the host library's C++ sources in the repo's ``native/`` directory
  (``subgc_native.cpp``, ``packed_reader.cpp``): compiled with the host
  compiler (``$CXX``, else ``g++``) and ``native/Makefile``'s flags, keyed
  by a hash of the source and the flags.  The JAX package builds its own
  copies inside ``native/``; the port never writes there.

Every library goes to ``_build/<name>-<hash>.so`` beside this module: the
compiler writes a temporary file that is renamed into place, so processes
that build at once agree.  A failed build raises with the compiler's
output.  Nothing is built when the module is imported.

:func:`entry` looks up a kernel library's C entry and sets its signature
once; :func:`launch` calls it on a card's current stream and raises on the
error code it returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
NATIVE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_loaded = {}
_entries = {}           # (library, entry) -> ctypes function
_entry_lock = threading.Lock()
# name -> {"seconds": build seconds (0.0 when cached), "log": compiler output}
BUILD_INFO = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's kernels are built from source with it")
    return path


def host_compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found; the port's "
                           f"host library is built from native/ with it")
    return found


def source_digest(name: str) -> str:
    """Hash of ``<name>``, every file under ``csrc/`` and the nvcc flags."""
    digest = hashlib.sha256(f"{name}\0{' '.join(NVCC_FLAGS)}".encode())
    for fname in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f"\0{fname}\0".encode() + f.read())
    return digest.hexdigest()[:16]


def _compile(name: str, out: str, cmd) -> str:
    """Run ``cmd(tmp)`` to write a library to a temporary file, rename it to
    ``out`` (atomic: concurrent builds agree) and record the build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return out


def library_path(name: str) -> str:
    """Build ``csrc/<name>.cu`` if its hashed library is missing; return the
    path of the shared library."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"{name}-{source_digest(name)}.so")
    if os.path.exists(out):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    return _compile(name, out,
                    lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src])


def host_library_path(name: str) -> str:
    """Build ``native/<name>.cpp`` with the host compiler if its hashed
    library is missing; return the path of the shared library."""
    src = os.path.join(NATIVE, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(HOST_FLAGS).encode() + b"\0"
                                + f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(out):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    return _compile(name, out,
                    lambda tmp: [host_compiler(), *HOST_FLAGS, "-o", tmp,
                                 src])


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(library_path(name))
        return _loaded[name]


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for ``native/<name>.cpp``, built on first use."""
    with _lock:
        key = f"native/{name}"
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(host_library_path(name))
        return _loaded[key]


def entry(lib: str, name: str, argtypes):
    """The C entry ``name`` of ``csrc/<lib>.cu``'s library, returning an
    ``int`` error code: built, loaded and given ``argtypes`` on first use
    (once, however many threads ask at the same time)."""
    fn = _entries.get((lib, name))
    if fn is not None:
        return fn
    with _entry_lock:
        if (lib, name) not in _entries:
            fn = getattr(load(lib), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[(lib, name)] = fn
        return _entries[(lib, name)]


def launch(what: str, fn, device, *args):
    """``fn(*args, stream)`` with ``device`` current and ``stream`` its
    current CUDA stream; raises if the entry returns an error code."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
