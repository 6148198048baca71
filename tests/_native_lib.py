"""Wait for the JAX package's host library before a test relies on it.

``subgc_tpu/ops/native.py`` builds ``native/libsubgc_native.so`` in place
(``make``; the linker writes the output file where it stands) and loads it
once: a process that finds a library another process is still writing
sees it newer than its source, skips ``make``, fails to load it, and then
reports ``available() == False`` for the rest of its life.  Test workers
that start at once in a fresh tree meet exactly that.

:func:`wait_for_native` takes such a module (anything with ``_SO_PATH``,
``_NATIVE_DIR``, ``_lib``, ``_tried`` and ``available()``), waits under a
lock until its library is up to date and loads in a fresh ``ctypes.CDLL``,
then clears the module's memory of the failed load so that ``available()``
loads it again.  It raises, with the loader's last error, when that does
not happen within ``timeout`` seconds.
"""
import ctypes
import fcntl
import os
import time

SOURCE = "subgc_native.cpp"


def _try_load(mod):
    """None when the library is up to date and loads, else why not."""
    so = mod._SO_PATH
    src = os.path.join(mod._NATIVE_DIR, SOURCE)
    if not os.path.exists(so):
        return f"{so} does not exist"
    if os.path.getmtime(so) < os.path.getmtime(src):
        return f"{so} is older than {src}"
    try:
        ctypes.CDLL(so)
    except OSError as e:
        return f"{so} does not load: {e}"
    return None


def wait_for_native(mod, timeout=60.0, poll=0.25):
    """Make ``mod.available()`` load a whole library (see the module
    docstring); raise AssertionError if none loads within ``timeout``."""
    src = os.path.join(mod._NATIVE_DIR, SOURCE)
    # the lock is taken on the source itself: no file is created for it
    with open(src, "rb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + timeout
            while True:
                if mod._lib is None:
                    mod._tried = False     # forget a failed earlier load
                    mod.available()        # builds if missing or stale
                why = _try_load(mod)
                if why is None and mod.available():
                    return
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"the JAX package's host library did not build or "
                        f"load within {timeout:g} s: {why}")
                time.sleep(poll)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
