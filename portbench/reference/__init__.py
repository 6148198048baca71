"""The plain-PyTorch Sub-GC and Full-GC the benchmark judges the port by.

It imports torch and numpy only: nothing of the program under test, and no
JAX."""
