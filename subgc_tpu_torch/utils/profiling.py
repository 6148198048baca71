"""Tracing and profiling utilities.

The counterpart of ``subgc_tpu/utils/profiling.py``.  The reference's only
observability is wall-clock prints every 5 iterations with explicit CUDA
synchronizes (`train.py:134-174`); here: phase timers with summary
statistics, the analytic decode FLOP count, and a context manager around
``torch.profiler`` that writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


def decode_flops_per_row(cfg) -> int:
    """Analytic matmul FLOPs of ONE decode-step row (one beam / sub-graph
    slot for one token step) at config dims, the JAX package's count: the
    terms of the split-matmul decode step (``models/decoder.py``); the
    fold / merge variants move the same FLOPs between matmuls."""
    R, E, H, N = (cfg.rnn_size, cfg.input_encoding_size, cfg.att_hid_size,
                  cfg.obj_num)
    V1 = cfg.vocab_size + 1
    return (2 * R * 4 * R          # att-LSTM h_lang @ w_ih[:R]
            + 2 * E * 4 * R        # att-LSTM xt @ w_ih[2R:]
            + 2 * R * 4 * R        # att-LSTM h_att @ w_hh
            + 2 * R * H + 2 * N * H + 2 * N * R   # additive attention
            + 2 * 2 * R * 4 * R    # lang-LSTM [att_res, h_att] @ w_ih
            + 2 * R * 4 * R        # lang-LSTM h_lang @ w_hh
            + 2 * R * V1)          # logit projection


class PhaseTimers:
    """Accumulating named timers (host wall-clock)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a block; with ``sync`` (a device) the block's device work
        is waited for and counted (``torch.cuda.synchronize`` on a CUDA
        device; on the CPU the work is done when the block returns)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                import torch
                if torch.device(sync).type == "cuda":
                    torch.cuda.synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "count": self.counts[k],
                    "mean_ms": round(1e3 * self.totals[k]
                                     / max(self.counts[k], 1), 3)}
                for k in sorted(self.totals)}

    def report(self) -> str:
        lines = [f"{k:>24}: {v['total_s']:8.2f}s / {v['count']:6d} = "
                 f"{v['mean_ms']:8.2f}ms" for k, v in self.summary().items()]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` (CPU, and CUDA where a card is present) around a
    block; writes ``<logdir>/trace.json``, a Chrome trace (chrome://tracing
    or Perfetto).  Yields the trace file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
