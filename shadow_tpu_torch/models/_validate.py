"""Shared model-arg validation helpers."""

from __future__ import annotations


def positive_interval(interval_ns: int, model: str) -> int:
    if interval_ns <= 0:
        raise ValueError(
            f"{model}: --interval must be > 0 (a zero interval would fire "
            "the timer at the same instant forever)"
        )
    return interval_ns
