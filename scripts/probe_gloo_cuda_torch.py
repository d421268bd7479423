#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors in this PyTorch build.

    python3 scripts/probe_gloo_cuda_torch.py

Two gloo ranks share card 0 (as the port's TP and EP ranks do when a host
has fewer cards than ranks, ``parallel/mesh.backend_for``) and try the
collectives the port calls on CUDA tensors: all-reduce, all-gather and
broadcast (f32, bf16, int64), and ``all_to_all_single`` with equal splits
and with uneven split sizes (bf16, int32; the expert-parallel mesh's
dense and ragged forms).  Each result is held to what the collective
must return.  Prints the PyTorch version, the card and its power limit,
and one line a collective and dtype: ``ok``, ``wrong`` or the error it
raised.
"""

import os
import subprocess
import sys
import tempfile

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
