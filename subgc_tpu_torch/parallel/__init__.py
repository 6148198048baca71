"""Parallelism for the port: a device mesh for sharded decoding in one
process (``mesh.py``) and a process group for data-parallel training
(``distributed.py``, ``launch.py``)."""
