"""The benchmark of the PyTorch and CUDA port, ``subgc_tpu_torch``, on one
NVIDIA H100: its harness, seeded traffic, plain reference, per-layer
readers and their tests.  It imports nothing of the JAX package."""
