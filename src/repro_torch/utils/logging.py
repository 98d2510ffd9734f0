"""The wall-clock probe of the staging instrumentation (the port's twin of
``timed`` in the JAX package's ``utils/logging.py``)."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator


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
