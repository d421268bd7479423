"""Captured decode steps: the port's counterpart of the JAX engines' jitted
steps (``Engine._get_jitted``, the scheduler's ``_jit_decode``).

A ``StepGraphs`` holds one engine's steps by key.  On the card the first
step of a key runs eagerly, as real work: it is the warm-up that builds
the split plans' workspaces, cuBLAS's handles and the kernels'
shared-memory attributes.  The second step of the key is captured into a
CUDA graph, then replayed; every later step replays.  The capture records
and runs nothing, so it appends no KV row and advances no generator: the
replay that follows it is the second step.  A capture or a replay that
fails raises; nothing falls back to running eagerly.  Python's cyclic
collector is held off while a step is captured: a dead engine it frees
there would destroy that engine's graphs mid-capture, which invalidates
the capture (torch's graph context no longer collects before it starts).

A step body takes no arguments: it reads and updates the engine's static
buffers in place, since a graph binds addresses.  What it returns is the
graph's output, overwritten by the next replay of any graph of the
engine (they share one memory pool, freed with the engine).  Generators
a body draws from are registered with its graph; a replay draws from
their state at that moment and advances it as the eager step would.

The kernel wrappers count launches where Python calls them.  A capture
takes its own calls back out of the counts and keeps them as the graph's
delta; each replay adds the delta, so a run's counts are the same whether
its steps ran eagerly or replayed.

The collectives of a TP step (``parallel/mesh.all_reduce`` /
``all_gather``) count the same way: an NCCL collective is captured with
the kernels, and each replay adds it.  An engine whose step calls gloo
collectives (they run on the host) is built with ``capture=False`` and
runs every step eagerly.  The GSPMD layouts of ``parallel/tp_step``
(the whole-row maxima, the gather before a whole ``o``) take the same
path, but their capture over NCCL is untested on cards:
``scripts/time_tp_torch.py`` on four cards checks it, captured against
eager bit for bit.

``eager_steps()`` runs the same bodies eagerly on the card, the
counterpart of ``jax.disable_jit()``: the yardstick of ``chip_smoke.py``
and the card tests.  On the CPU every step runs eagerly (the CPU has no
graphs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable, Dict, Hashable, Iterable, Optional

import torch

from qwen_inference_engine_tpu_torch.utils.metrics import (
    add_launches,
    counted_wrappers,
    launch_counts,
)

_EAGER = [0]


@contextlib.contextmanager
def eager_steps():
    """Run every step body eagerly while the context is open, on every
    thread: the eager yardstick of a captured step."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def eager() -> bool:
    """Whether ``eager_steps()`` is open."""
    return _EAGER[0] > 0


@dataclasses.dataclass
class _Captured:
    graph: object
    outputs: object
    delta: Dict[str, int]


class StepGraphs:
    """One engine's step bodies by key, each captured once and replayed.
    ``cuda`` is the module that makes the graphs (``torch.cuda``; a test
    passes a stand-in), ``wrappers`` the launch counters
    (``counted_wrappers()``: the kernels' and the collectives'), and
    ``capture`` False runs every step eagerly (steps with host-side
    collectives)."""

    def __init__(self, device, *, wrappers: Optional[Dict] = None,
                 cuda=None, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture
        self._cuda = cuda if cuda is not None else torch.cuda
        self._wrappers = wrappers
        self._steps: Dict[Hashable, Optional[_Captured]] = {}
        self._pool = None
        self.capture_s = 0.0    # host seconds spent capturing

    @property
    def captured(self) -> int:
        """How many graphs this engine holds."""
        return sum(s is not None for s in self._steps.values())

    def run(self, key: Hashable, body: Callable[[], object],
            generators: Iterable[torch.Generator] = ()):
        """One step of ``key``: ``body()`` eagerly on the CPU, under
        ``eager_steps()`` and for a key's first step; its capture at the
        key's second step; then a replay.  Returns the step's outputs."""
        if self.device.type != "cuda" or eager() or not self.capture:
            return body()
        if key not in self._steps:
            out = body()
            self._steps[key] = None
            return out
        step = self._steps[key]
        if step is None:
            step = self._steps[key] = self._capture(body, generators)
        step.graph.replay()
        add_launches(self._counters(), step.delta)
        return step.outputs

    def _counters(self) -> Dict[str, Callable]:
        if self._wrappers is None:
            self._wrappers = counted_wrappers()
        return self._wrappers

    def _capture(self, body, generators) -> _Captured:
        cuda = self._cuda
        if self._pool is None:
            self._pool = cuda.graph_pool_handle()
        t0 = time.perf_counter()
        graph = cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        wrappers = self._counters()
        before = launch_counts(wrappers)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # other threads (the HTTP server's) may touch CUDA meanwhile
            with cuda.graph(graph, pool=self._pool,
                            capture_error_mode="thread_local"):
                outputs = body()
        finally:
            if collecting:
                gc.enable()
            # the capture's calls launched nothing: take them back out
            after = launch_counts(wrappers)
            delta = {n: after[n] - c for n, c in before.items()
                     if after[n] != c}
            add_launches(wrappers, {n: -d for n, d in delta.items()})
        self.capture_s += time.perf_counter() - t0
        return _Captured(graph, outputs, delta)
