"""Packed binary dataset: fixed-record shards for the production input path.

The counterpart of ``subgc_tpu/data/packed.py``, in the same format: a
shard written by either package reads in both, and the writers produce the
same bytes.  The reference reads one pickled npz per image per access
(`dataloaders/dataloader.py:14-37`); a shard is one flat, mmap-able file of
fixed-size records, read without per-item decompression, through the C++
reader (``ops/native_packed.py``) or numpy views over the same mapping.

Shard layout (little-endian), all images padded to the config's static
shapes at pack time:

  header (64 bytes):
    magic     uint64  0x53554247'43504B31  ("SUBGCPK1")
    n_images  uint32
    obj_num   uint32   rel_num  uint32   feat_dim uint32
    n_obj_cls uint32   n_rel_cls uint32  max_subg uint32  reserved uint32
    record_sz uint64   (bytes per image record)
    reserved  16 bytes

  per-image record:
    img_id      int64
    n_obj, n_rel, n_subg  int32 x3  (+ int32 pad)
    obj_fmap    float32 [obj_num, feat_dim]
    obj_dist    float32 [obj_num, n_obj_cls]
    rel_ind     int32   [rel_num, 2]
    pred_dist   float32 [rel_num, n_rel_cls]
    boxes       float32 [obj_num, 4]
    node_iou    float32 [5, 5 + max_subg]
    sub_obj_ind  int32  [5 + max_subg, obj_num]   (left-packed, pad = obj_num-1)
    sub_att_mask uint8  [5 + max_subg, obj_num]
    sub_pred_ind int32  [5 + max_subg, rel_num]
"""
from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Optional

import numpy as np

MAGIC = 0x5355424743504B31
HEADER = "<QIIIIIIIIQ"          # the first 48 of the header's 64 bytes


class PackedSpec(NamedTuple):
    obj_num: int = 37
    rel_num: int = 65
    feat_dim: int = 2048
    n_obj_cls: int = 1599
    n_rel_cls: int = 21
    max_subg: int = 1000

    @property
    def total_subg(self) -> int:
        return 5 + self.max_subg

    def record_fields(self):
        s = self
        return [
            ("img_id", np.int64, ()),
            ("counts", np.int32, (4,)),
            ("obj_fmap", np.float32, (s.obj_num, s.feat_dim)),
            ("obj_dist", np.float32, (s.obj_num, s.n_obj_cls)),
            ("rel_ind", np.int32, (s.rel_num, 2)),
            ("pred_dist", np.float32, (s.rel_num, s.n_rel_cls)),
            ("boxes", np.float32, (s.obj_num, 4)),
            ("node_iou", np.float32, (5, s.total_subg)),
            ("sub_obj_ind", np.int32, (s.total_subg, s.obj_num)),
            ("sub_att_mask", np.uint8, (s.total_subg, s.obj_num)),
            ("sub_pred_ind", np.int32, (s.total_subg, s.rel_num)),
        ]

    def field_offsets(self) -> Dict[str, tuple]:
        """name -> (byte offset in a record, dtype, shape, bytes)."""
        out, off = {}, 0
        for name, dt, shape in self.record_fields():
            size = np.dtype(dt).itemsize * int(np.prod(shape) or 1)
            out[name] = (off, dt, shape, size)
            off += size
        return out

    @property
    def record_size(self) -> int:
        return sum(size for _, _, _, size in self.field_offsets().values())


def pack_image(spec: PackedSpec, img_id: int, sg: Dict,
               mask_bank: Optional[Dict]) -> bytes:
    """One image's npz dicts -> a fixed-size record (padding semantics of
    dataloader.py:335-357 / the left-packing of :269-303)."""
    s = spec
    fmap = np.zeros((s.obj_num, s.feat_dim), np.float32)
    dist = np.zeros((s.obj_num, s.n_obj_cls), np.float32)
    dist[:, 0] = 1.0
    n = min(np.asarray(sg["object_fmap"]).shape[0], s.obj_num - 1)
    fmap[:n] = sg["object_fmap"][:n]
    dist[:n] = sg["object_dist"][:n]

    rind = np.full((s.rel_num, 2), s.obj_num - 1, np.int32)
    pdist = np.zeros((s.rel_num, s.n_rel_cls), np.float32)
    pdist[:, 0] = 1.0
    k = min(np.asarray(sg["rel_ind"]).shape[0], s.rel_num - 1)
    rind[:k] = sg["rel_ind"][:k]
    pdist[:k] = sg["pred_dist"][:k]

    boxes = np.zeros((s.obj_num, 4), np.float32)
    nb = min(np.asarray(sg["boxes"]).shape[0], s.obj_num)
    boxes[:nb] = sg["boxes"][:nb]

    node_iou = np.zeros((5, s.total_subg), np.float32)
    soi = np.full((s.total_subg, s.obj_num), s.obj_num - 1, np.int32)
    sam = np.zeros((s.total_subg, s.obj_num), np.uint8)
    spi = np.full((s.total_subg, s.rel_num), s.rel_num - 1, np.int32)
    n_subg = 0
    if mask_bank is not None:
        iou = np.asarray(mask_bank["node_iou_mtx"], np.float32)
        cols = min(iou.shape[1], s.total_subg)
        node_iou[:, :cols] = iou[:, :cols]
        entries = mask_bank["subgraph_mask_list"][:s.total_subg]
        n_subg = max(0, len(entries) - 5)
        for i, entry in enumerate(entries):
            onz = np.asarray(entry[1]).nonzero()[0]
            soi[i, :onz.shape[0]] = onz
            sam[i, :onz.shape[0]] = 1
            pnz = np.asarray(entry[2]).nonzero()[0]
            spi[i, :pnz.shape[0]] = pnz

    rec = bytearray(struct.pack("<q", int(img_id)))
    rec += np.asarray([n, k, n_subg, 0], np.int32).tobytes()
    for arr in [fmap, dist, rind, pdist, boxes, node_iou, soi, sam, spi]:
        rec += np.ascontiguousarray(arr).tobytes()
    if len(rec) != spec.record_size:
        raise ValueError(f"record of {len(rec)} bytes, spec says "
                         f"{spec.record_size}")
    return bytes(rec)


def write_shard(path: str, spec: PackedSpec, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(HEADER, MAGIC, len(records), spec.obj_num,
                            spec.rel_num, spec.feat_dim, spec.n_obj_cls,
                            spec.n_rel_cls, spec.max_subg, 0,
                            spec.record_size))
        f.write(b"\0" * (64 - struct.calcsize(HEADER)))
        for r in records:
            f.write(r)


def read_header(path: str):
    """(PackedSpec, n_images) of a shard; raises ValueError on a file that
    is not one (bad magic, a record size its spec does not give, or fewer
    bytes than its records need)."""
    with open(path, "rb") as f:
        hdr = f.read(64)
        f.seek(0, 2)
        size = f.tell()
    if len(hdr) < 64:
        raise ValueError(f"{path}: {len(hdr)} bytes, shorter than a header")
    (magic, n_images, obj_num, rel_num, feat_dim, n_obj_cls, n_rel_cls,
     max_subg, _res, record_size) = struct.unpack(HEADER, hdr[:48])
    if magic != MAGIC:
        raise ValueError(f"bad shard magic in {path}")
    spec = PackedSpec(obj_num, rel_num, feat_dim, n_obj_cls, n_rel_cls,
                      max_subg)
    if record_size != spec.record_size:
        raise ValueError(f"{path}: record size {record_size}, its spec "
                         f"gives {spec.record_size}")
    if size < 64 + n_images * record_size:
        raise ValueError(f"{path}: {size} bytes for {n_images} records of "
                         f"{record_size}")
    return spec, n_images


class _Record:
    """Dict-like field accessor over one record buffer: a field becomes a
    (read-only) numpy view when it is first read."""
    __slots__ = ("_buf", "_offsets", "_cache")

    def __init__(self, buf, offsets):
        self._buf = buf
        self._offsets = offsets
        self._cache = {}

    def __getitem__(self, name):
        v = self._cache.get(name)
        if v is None:
            off, dt, shape, size = self._offsets[name]
            v = np.frombuffer(self._buf[off:off + size],
                              dtype=dt).reshape(shape)
            if name == "img_id":
                v = int(v[()])
            self._cache[name] = v
        return v

    def keys(self):
        return self._offsets.keys()


class PackedShard:
    """A shard read through the C++ reader (``use_native``, the default;
    a failed build or open raises) or through numpy views of its mmap."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        self.spec, self.n_images = read_header(path)
        self.record_size = self.spec.record_size
        self._offsets = self.spec.field_offsets()
        self._native = None
        self._mm = None
        if use_native:
            from ..ops.native_packed import NativePackedReader
            self._native = NativePackedReader(path)
        else:
            self._mm = np.memmap(path, np.uint8, "r", offset=64,
                                 shape=(self.n_images, self.record_size))

    def image_ids(self) -> np.ndarray:
        if self._native is not None:
            return self._native.image_ids()
        off = self._offsets["img_id"][0]
        return np.ascontiguousarray(self._mm[:, off:off + 8]).view(
            np.int64)[:, 0].copy()

    def record(self, i: int) -> _Record:
        """Zero-copy lazy view of record ``i``: keep the shard alive while
        its fields are in use."""
        if self._native is not None:
            return self._native.record(i)
        if not 0 <= i < self.n_images:
            raise IndexError(i)
        return _Record(self._mm[i], self._offsets)
