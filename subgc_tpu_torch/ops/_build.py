"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` file has a plain C interface.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``_build/<name>-<hash>.so`` beside this
module, keyed by a hash of every file under ``csrc/`` and the flags, and
loaded with ``ctypes``.  Nothing is built when the module is imported.
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

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded = {}
# name -> {"seconds": build seconds (0.0 when cached), "log": nvcc output}
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


def source_digest(name: str) -> str:
    """Hash of ``<name>``, every file under ``csrc/`` (a header it includes
    changes the library too) and the flags."""
    digest = hashlib.sha256(f"{name}\0{' '.join(NVCC_FLAGS)}".encode())
    for fname in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f"\0{fname}\0".encode() + f.read())
    return digest.hexdigest()[:16]


def library_path(name: str) -> str:
    """Build ``csrc/<name>.cu`` if its hashed library is missing; return the
    path of the shared library."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"{name}-{source_digest(name)}.so")
    if os.path.exists(out):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)      # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(library_path(name))
        return _loaded[name]
