"""A persistent gloo world of CPU processes for the port's TP/DP tests.

``World(n)`` spawns ``n`` ranks once (``parallel/mesh.spawn``: a
``file://`` rendezvous in a fresh temporary directory, so worlds of
parallel test workers never collide) and keeps them for a test module.
``World.run(fn, *args)`` runs ``fn(mesh_of, rank, *args)`` on every rank
and returns the ranks' results in rank order, within a time limit;
``mesh_of((dp, tp))`` is that world's mesh of that shape, made once on
every rank.  This module imports no JAX: the ranks import only the port.
"""

from __future__ import annotations

import queue
import shutil
import traceback

from qwen_inference_engine_tpu_torch.parallel.mesh import make_mesh, spawn

_MESHES = {}


def mesh_of(shape):
    """The world's mesh of ``shape`` (made on first use; every rank runs the
    same jobs in the same order, so every rank makes it at once)."""
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(shape)
    return _MESHES[shape]


def _serve(rank, world_size, jobs, results):
    import torch

    torch.set_num_threads(1)
    while True:
        job = jobs[rank].get()
        if job is None:
            return
        fn, args = job
        try:
            results.put((rank, True, fn(mesh_of, rank, *args)))
        except Exception:   # the test reports the rank's traceback
            results.put((rank, False, traceback.format_exc()))


class World:
    def __init__(self, size: int):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.size = size
        self._jobs = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        self._procs = spawn(_serve, size,
                            args=(self._jobs, self._results), join=False)

    def run(self, fn, *args, timeout: float = 120.0):
        """``fn(mesh_of, rank, *args)`` on every rank; the results in rank
        order.  A rank that raises fails the call with its traceback."""
        for q in self._jobs:
            q.put((fn, args))
        got = {}
        while len(got) < self.size:
            try:
                rank, ok, out = self._results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"world of {self.size}: {fn.__name__} "
                                   f"took more than {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank}:\n{out}")
            got[rank] = out
        return [got[r] for r in range(self.size)]

    def close(self) -> None:
        for q in self._jobs:
            q.put(None)
        self._procs.join(timeout=30)
        for p in self._procs.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(getattr(self._procs, "rendezvous_dir", ""),
                      ignore_errors=True)
