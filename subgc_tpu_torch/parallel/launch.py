"""Spawn one process per rank and run a function of this package in each.

``spawn(fn, world, devices, backend, args)`` starts ``world`` processes
(``torch.multiprocessing``, the spawn method), joins them into one process
group on a free local TCP port, places rank r on ``devices[r]`` and calls
``fn(rank, world, device, startup_seconds, *args)``.  ``fn`` must be a
module-level function of an importable module, so that a spawned rank
imports only what it names; the spawning script's own entry code must sit
under ``if __name__ == "__main__"``, as a spawned rank imports it again.
A rank that raises makes :func:`spawn` raise (the others are stopped);
nothing falls back to fewer ranks.

NCCL refuses two ranks on one card, so two ranks that share a card (a
one-card rehearsal of a multi-card run) take gloo, whose ``all_reduce`` and
``broadcast`` take CUDA tensors (through the host).
"""
from __future__ import annotations

import socket
import time

import torch
import torch.distributed as dist


def free_port() -> int:
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pick_backend(devices) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def _entry(rank, fn, world, devices, backend, init_method, t_spawn, args):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        fn(rank, world, dev, time.time() - t_spawn, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, devices, backend=None, args=()):
    """Run ``fn(rank, world, device, startup_seconds, *args)`` in ``world``
    spawned ranks; ``startup_seconds`` is the time from this call to the
    rank's group being up.  ``backend`` defaults to :func:`pick_backend`."""
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got "
                         f"{len(devices)}")
    backend = backend or pick_backend(devices)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_entry, args=(fn, world, devices, backend,
                                     init_method, time.time(), tuple(args)),
                       nprocs=world, join=True, start_method="spawn")
