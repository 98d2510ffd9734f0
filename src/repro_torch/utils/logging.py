"""Tiny structured logger (stdout + optional jsonl file) and the shared
wall-clock probe used by the pipeline instrumentation (the port's twin of
the JAX package's ``utils/logging.py``)."""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any, Callable, Iterator, Optional


@contextlib.contextmanager
def timed(on_done: Callable[[float], None]) -> Iterator[None]:
    """Measure the block's wall time and hand the seconds to ``on_done``.

    A caller that times device work fences it inside the block (a CUDA
    event's ``synchronize``): copies and kernels run asynchronously, so an
    unfenced timestamp would under-measure them."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        on_done(time.perf_counter() - t0)


class MetricLogger:
    """``log(step, **metrics)`` prints one line to stderr (unless
    ``quiet``) and appends one record ``{"step", "t", **metrics}`` to the
    jsonl file (truncated when the logger is made); ``t`` is the seconds
    since then. The records are the reference's, field for field."""

    def __init__(self, jsonl_path: Optional[str] = None, quiet: bool = False):
        self.jsonl_path = jsonl_path
        self.quiet = quiet
        self._t0 = time.perf_counter()
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            open(jsonl_path, "w").close()

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step, "t": round(time.perf_counter() - self._t0, 3),
               **metrics}
        if not self.quiet:
            parts = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            )
            print(f"[step {step:>5}] {parts}", file=sys.stderr)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
