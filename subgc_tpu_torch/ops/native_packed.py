"""ctypes binding to the packed-shard reader (``native/packed_reader.cpp``).

The counterpart of ``subgc_tpu/ops/native_packed.py``: the C++ side mmaps a
shard (format: ``data/packed.py``), checks its header and hands out
pointers into the mapping, or copies a batch of records in one call.  The
library is built at first use by ``ops/_build.py``; a failed build, load
or open raises (the JAX binding prints and returns None instead).
"""
from __future__ import annotations

import ctypes
import struct
import threading
from typing import Sequence

import numpy as np

from . import _build

_lib = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded reader with its signatures set, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load_host("packed_reader")
            lib.subgc_packed_open.restype = ctypes.c_void_p
            lib.subgc_packed_open.argtypes = [ctypes.c_char_p]
            lib.subgc_packed_close.restype = None
            lib.subgc_packed_close.argtypes = [ctypes.c_void_p]
            lib.subgc_packed_count.restype = ctypes.c_uint32
            lib.subgc_packed_count.argtypes = [ctypes.c_void_p]
            lib.subgc_packed_header.restype = None
            lib.subgc_packed_header.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
            lib.subgc_packed_record.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.subgc_packed_record.argtypes = [ctypes.c_void_p,
                                                ctypes.c_uint32]
            lib.subgc_packed_ids.restype = None
            lib.subgc_packed_ids.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_int64)]
            lib.subgc_packed_gather.restype = ctypes.c_uint32
            lib.subgc_packed_gather.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8)]
            _lib = lib
        return _lib


class NativePackedReader:
    """One shard opened by the C++ reader; closed by :meth:`close` or when
    the reader is collected.  Record views alias the mapping."""

    def __init__(self, path: str):
        from ..data.packed import HEADER, PackedSpec
        self.lib = library()
        self.handle = self.lib.subgc_packed_open(path.encode())
        if not self.handle:
            raise RuntimeError(f"cannot open shard {path} (missing, or not "
                               f"a shard: bad magic or size)")
        hdr = (ctypes.c_uint8 * 48)()
        self.lib.subgc_packed_header(self.handle, hdr)
        (_magic, self.n_images, obj_num, rel_num, feat_dim, n_obj_cls,
         n_rel_cls, max_subg, _res, self.record_size) = struct.unpack(
            HEADER, bytes(hdr))
        self.spec = PackedSpec(obj_num, rel_num, feat_dim, n_obj_cls,
                               n_rel_cls, max_subg)
        if self.record_size != self.spec.record_size:
            self.close()
            raise ValueError(f"{path}: record size {self.record_size}, its "
                             f"spec gives {self.spec.record_size}")
        self._offsets = self.spec.field_offsets()

    def close(self):
        if self.handle:
            self.lib.subgc_packed_close(self.handle)
            self.handle = None

    def __del__(self):
        if getattr(self, "handle", None):
            self.close()

    def image_ids(self) -> np.ndarray:
        out = np.zeros(self.n_images, np.int64)
        self.lib.subgc_packed_ids(
            self.handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def record(self, i: int):
        """Zero-copy lazy view of record ``i`` (fields parse on first
        access); keep the reader alive while the view is in use."""
        from ..data.packed import _Record
        if not 0 <= i < self.n_images:
            raise IndexError(i)
        ptr = self.lib.subgc_packed_record(self.handle, i)
        buf = np.ctypeslib.as_array(ptr, shape=(self.record_size,))
        return _Record(buf, self._offsets)

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        """Records at ``indices`` copied into one [n, record_size] uint8
        array; IndexError on an index out of range (the C side stops at
        the first bad one)."""
        idx = np.asarray(indices, np.int64)
        if (idx < 0).any():
            raise IndexError(f"record index {int(idx[idx < 0][0])} out of "
                             f"range")
        idx = idx.astype(np.uint32)
        out = np.zeros((len(idx), self.record_size), np.uint8)
        done = self.lib.subgc_packed_gather(
            self.handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if done != len(idx):
            raise IndexError(f"record index {int(idx[done])} out of range "
                             f"(shard has {self.n_images} images)")
        return out
