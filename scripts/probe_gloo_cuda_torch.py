#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors in this PyTorch build.

    python3 scripts/probe_gloo_cuda_torch.py

Two gloo ranks share card 0 (as the port's TP and EP ranks do when a host
has fewer cards than ranks, ``parallel/mesh.backend_for``) and try the
collectives the port calls on CUDA tensors: all-reduce, all-gather and
broadcast (f32, bf16, int64), and ``all_to_all_single`` with equal splits
and with uneven split sizes (bf16, int32; the expert-parallel mesh's
dense and ragged forms), and ``reduce_scatter_tensor`` (f32, bf16: the
sequence-parallel prefill's sum over tokens, each rank keeping its own
slice).  Then, in a second world of two ranks (a rank
that dies there costs only these lines), the point-to-point forms the
pipeline's ring exchange can take (``parallel/mesh.ring_exchange``):
``send`` / ``recv``, ``batch_isend_irecv`` over the whole ring and from
one rank to the next alone, and ``all_to_all_single`` with every split
but the next rank's empty (bf16).  Each result is held to what the call
must return.  Prints the PyTorch version, the card and its power limit,
and one line a call and dtype: ``ok``, ``wrong``, the error it raised,
or ``died`` / ``hung`` for a world that ended without an answer.
"""

import datetime
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _try(fn):
    try:
        ok = fn()
        torch.cuda.synchronize()
        return "ok" if ok is not False else "wrong"
    except Exception as e:  # the probe reports what the build refuses
        return f"{type(e).__name__}: {str(e)[:100]}"


def _a2a_equal(rank, world, dt):
    # rank r sends value 10 * r + p to peer p, 3 rows each
    send = torch.tensor([10 * rank + p for p in range(world) for _ in
                         range(3)], device="cuda").to(dt)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    want = torch.tensor([10 * s + rank for s in range(world) for _ in
                         range(3)], device="cuda").to(dt)
    return bool(torch.equal(recv, want))


def _a2a_uneven(rank, world, dt):
    # rank r sends r + p + 1 rows of value 10 * r + p to peer p
    sizes = [rank + p + 1 for p in range(world)]
    send = torch.cat([torch.full((n, 2), 10 * rank + p, device="cuda")
                      for p, n in enumerate(sizes)]).to(dt)
    got = [s + rank + 1 for s in range(world)]
    recv = torch.empty((sum(got), 2), device="cuda").to(dt)
    dist.all_to_all_single(recv, send, output_split_sizes=got,
                           input_split_sizes=sizes)
    want = torch.cat([torch.full((n, 2), 10 * s + rank, device="cuda")
                      for s, n in enumerate(got)]).to(dt)
    return bool(torch.equal(recv, want))


def _reduce_scatter(rank, world, dt):
    # rank r holds value r + 1 in every row; a rank keeps its 4 rows summed
    t = torch.full((4 * world, 3), rank + 1, device="cuda").to(dt)
    out = torch.empty((4, 3), device="cuda").to(dt)
    dist.reduce_scatter_tensor(out, t)
    return bool(torch.equal(out, torch.full_like(
        out, world * (world + 1) // 2)))


def _p2p_ring(rank, world, batched):
    # rank r sends 3 rows of 10 * r to rank r + 1 and receives rank r - 1's
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    send = torch.full((3, 4), 10 * rank, device="cuda").to(torch.bfloat16)
    recv = torch.empty_like(send)
    if batched:
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, nxt),
                dist.P2POp(dist.irecv, recv, prv)]):
            req.wait()
    elif rank % 2 == 0:
        dist.send(send, nxt)
        dist.recv(recv, prv)
    else:
        dist.recv(recv, prv)
        dist.send(send, nxt)
    return bool(torch.equal(recv, torch.full_like(recv, 10 * prv)))


def _p2p_one_hop(rank, world):
    # rank 0 alone sends to rank 1; the other ranks post nothing
    t = torch.full((5,), 7.0, device="cuda").to(torch.bfloat16)
    if rank == 0:
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1)]):
            req.wait()
        return True
    if rank == 1:
        got = torch.empty_like(t)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.irecv, got, 0)]):
            req.wait()
        return bool(torch.equal(got, t))
    return True


def _a2a_ring(rank, world):
    # all_to_all_single as a ring: 3 rows to rank r + 1, none to the rest
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    send = torch.full((3, 4), 10 * rank, device="cuda").to(torch.bfloat16)
    recv = torch.empty_like(send)
    dist.all_to_all_single(
        recv, send, output_split_sizes=[3 if s == prv else 0
                                        for s in range(world)],
        input_split_sizes=[3 if p == nxt else 0 for p in range(world)])
    return bool(torch.equal(recv, torch.full_like(recv, 10 * prv)))


def run_p2p(rank: int, world: int, path: str, q) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    for name, fn in (("all_to_all_single ring (zero splits)",
                      lambda: _a2a_ring(rank, world)),
                     ("batch_isend_irecv ring",
                      lambda: _p2p_ring(rank, world, True)),
                     ("batch_isend_irecv one hop",
                      lambda: _p2p_one_hop(rank, world)),
                     ("send / recv ring",
                      lambda: _p2p_ring(rank, world, False))):
        res = _try(fn)
        if rank == 0:
            q.put((name, res))
    dist.destroy_process_group()


def probe_p2p(world: int = 2, limit_s: float = 240.0) -> None:
    """The point-to-point lines, from a world of its own: a case that kills
    a rank or hangs leaves the lines before it."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = mp.start_processes(
        run_p2p, args=(world, os.path.join(tempfile.mkdtemp(), "rdv"), q),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + limit_s
    done, err = False, None
    while not done and time.time() < deadline:
        try:
            done = procs.join(timeout=1)
        except Exception as e:  # a rank died
            err, done = f"died ({type(e).__name__}: {str(e)[:80]})", True
    for p in procs.processes:
        if p.is_alive():
            p.terminate()
            err = err or "hung"
    seen = set()
    while not q.empty():
        name, res = q.get()
        seen.add(name)
        print(f"gloo cuda {name} bfloat16: {res}", flush=True)
    if err is not None:
        print(f"gloo cuda point-to-point world: {err} after "
              f"{len(seen)} calls answered", flush=True)


def run(rank: int, world: int, path: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world)
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        t = torch.ones(8, dtype=dt, device="cuda")
        parts = [torch.empty_like(t) for _ in range(world)]
        out[f"all_reduce {dt}"] = _try(lambda: dist.all_reduce(t))
        out[f"all_gather {dt}"] = _try(lambda: dist.all_gather(parts, t))
        out[f"broadcast {dt}"] = _try(lambda: dist.broadcast(t, 0))
    for dt in (torch.bfloat16, torch.int32):
        out[f"all_to_all_single equal {dt}"] = _try(
            lambda: _a2a_equal(rank, world, dt))
        out[f"all_to_all_single uneven {dt}"] = _try(
            lambda: _a2a_uneven(rank, world, dt))
    for dt in (torch.float32, torch.bfloat16):
        out[f"reduce_scatter_tensor {dt}"] = _try(
            lambda: _reduce_scatter(rank, world, dt))
    if rank == 0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"torch {torch.__version__} | {torch.cuda.get_device_name(0)} "
              f"| {smi.stdout.strip()}")
        for k, v in out.items():
            print(f"gloo cuda {k}: {v}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    mp.spawn(run, args=(2, os.path.join(tempfile.mkdtemp(), "rdv")),
             nprocs=2)
    probe_p2p()
