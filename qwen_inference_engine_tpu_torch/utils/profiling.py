"""Profiling hooks: a ``torch.profiler`` trace and a step timer.

The port of the JAX package's ``utils/profiling.py``.  ``trace(dir)``
records the host's PyTorch ops and, on the card, the device's kernels
(the port's own CUDA kernels among them, by their C++ names) while its
block runs, and writes one Chrome trace (``chrome://tracing`` or Perfetto)
into ``dir`` (``generate --profile DIR`` on the CLI).  ``time_fn`` times
a function's calls by the host clock, each call ending in a sync that
waits for its device work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Record a profile of the block into ``trace_dir`` as
    ``trace_<pid>_<n>.json``; a no-op when ``trace_dir`` is falsy.  CUDA
    activity is recorded where a card is present."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    n = len(os.listdir(trace_dir))
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{n}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)


def _hard_sync(out) -> None:
    """Wait for ``out``'s device work: ``torch.cuda.synchronize()`` where a
    card is present, then a host copy of the smallest output tensor."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(out)
    if any(t.device.type == "cuda" for t in leaves) or (
            not leaves and torch.cuda.is_initialized()):
        torch.cuda.synchronize()
    if leaves:
        min(leaves, key=lambda t: t.numel()).cpu()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            **kw) -> dict:
    """Host-clock seconds of ``fn(*args, **kw)``: the median, min and mean
    over ``iters`` calls after ``warmup`` calls, each call ending in
    ``_hard_sync`` of its output (a launch returns before its work is
    done)."""
    for _ in range(warmup):
        out = fn(*args, **kw)
    if warmup:
        _hard_sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _hard_sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "mean_s": sum(times) / len(times),
        "iters": iters,
    }
