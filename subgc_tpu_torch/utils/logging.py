"""Training metrics logging: TensorBoard scalars + JSONL fallback; the
counterpart of ``subgc_tpu/utils/logging.py``.

The reference writes TB scalars for train/gpn/lang loss, LR, scheduled-
sampling prob and val loss (`train.py:59,183-209`); this logger mirrors
those tags and appends every record to ``metrics.jsonl`` so runs remain
inspectable without TB.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(logdir)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
