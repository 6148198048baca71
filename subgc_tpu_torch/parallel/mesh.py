"""Device mesh and sharding rules; the counterpart of
``subgc_tpu/parallel/mesh.py``.

The JAX package puts a ``(data, model)`` ``jax.sharding.Mesh`` over its
devices and lets XLA place each array's shards.  Here a mesh is a named
tuple of ``torch.device``s (JAX's ``data`` axis), and placement is explicit:
:func:`replicate` copies a tree to every device, :func:`shard_leading_axis`
cuts every leaf's leading axis into contiguous chunks, one per device, and
:func:`gather_leading_axis` puts the chunks back together in device order.
Test-time sharding (``eval/runner.py``, ``cli/serve.py --shard_fanout``)
runs one Python thread per device in one process over such a mesh, as the
JAX single-process mesh does; decoding needs no collective.  The JAX
mesh's ``model`` axis has no counterpart: nothing is sharded over it.

A mesh may name one device more than once (``make_mesh(devices=[cpu,
cpu])``, ``[cuda:0, cuda:0]``): the chunks then take turns on that device,
with the same results as on separate ones.  That is what the CPU tests and
a one-card run use, as the JAX tests use forced host devices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Mesh(NamedTuple):
    devices: tuple          # torch.device per position on the data axis

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_data: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_data`` of ``devices`` (default: every
    attached card)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is attached; pass devices= "
                               "(for example [torch.device('cpu')] * 2)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices)
    if n_data < 1 or n_data > len(devices):
        raise ValueError(f"a mesh of {n_data} needs {n_data} devices, got "
                         f"{len(devices)}")
    return Mesh(tuple(devices[:n_data]))


def tree_map(fn, tree):
    """``fn`` over every array leaf of a tree of dicts, lists, tuples and
    named tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x):
    return x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))


def replicate(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` per mesh device, contiguous there (a tensor
    already on a device is shared, not copied)."""
    return [tree_map(lambda x: _tensor(x).to(d).contiguous(), tree)
            for d in mesh.devices]


def shard_leading_axis(mesh: Mesh, tree) -> list:
    """Per mesh device, its contiguous chunk of every leaf's leading axis
    (``torch.tensor_split``: the first ``rows % n`` chunks take one row
    more), on that device."""
    n = mesh.size
    return [tree_map(lambda x, i=i, d=d: torch.tensor_split(
        _tensor(x), n)[i].to(d).contiguous(), tree)
        for i, d in enumerate(mesh.devices)]


def gather_leading_axis(chunks: Sequence):
    """Concatenate per-device trees along the leading axis, in device
    order, on the first chunk's device."""
    first = chunks[0]

    def cat(*xs):
        dev = xs[0].device
        return torch.cat([x.to(dev) for x in xs])

    return _zip_map(cat, first, list(chunks))


def _zip_map(fn, like, trees):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _zip_map(fn, like[k], [t[k] for t in trees])
                for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_zip_map(fn, v, [t[i] for t in trees])
                            for i, v in enumerate(like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_zip_map(fn, v, [t[i] for t in trees])
                          for i, v in enumerate(like))
    return fn(*trees)
