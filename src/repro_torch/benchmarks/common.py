"""Shared benchmark helpers: CSV row emission per the harness convention."""
from __future__ import annotations

import time
from typing import List

ROWS: List[str] = []


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    row = f"{name},{us_per_call:.3f},{derived}"
    ROWS.append(row)
    print(row, flush=True)


def timeit_us(fn, n: int = 100, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6
