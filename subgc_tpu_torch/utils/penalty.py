"""Beam length penalties (misc/utils.py:242-266)."""
from __future__ import annotations


def penalty_fn(penalty_config: str):
    """'' -> identity; 'wu_A' -> GNMT penalty; 'avg_A' -> mean logprob."""
    if not penalty_config:
        return lambda length, logprobs: logprobs
    pen_type, alpha = penalty_config.split("_")
    alpha = float(alpha)
    if pen_type == "wu":
        return lambda length, logprobs: logprobs / (
            ((5.0 + length) ** alpha) / ((5.0 + 1.0) ** alpha))
    if pen_type == "avg":
        return lambda length, logprobs: logprobs / length
    raise ValueError(f"unknown length penalty {penalty_config!r}")
