#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors in this PyTorch build.

    python3 scripts/probe_gloo_cuda_torch.py

Two gloo ranks share card 0 (as the port's TP ranks do when a host has
fewer cards than ranks, ``parallel/mesh.backend_for``) and try the three
collectives the port calls (all-reduce, all-gather, broadcast) on CUDA
tensors of f32, bf16 and int64.  Prints the PyTorch version, the card and
one line a collective and dtype: ``ok`` or the error it raised.
"""

import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _try(fn):
    try:
        fn()
        torch.cuda.synchronize()
        return "ok"
    except Exception as e:  # the probe reports what the build refuses
        return f"{type(e).__name__}: {str(e)[:100]}"


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
    if rank == 0:
        print(f"torch {torch.__version__} | {torch.cuda.get_device_name(0)}")
        for k, v in out.items():
            print(f"gloo cuda {k}: {v}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    mp.spawn(run, args=(2, os.path.join(tempfile.mkdtemp(), "rdv")),
             nprocs=2)
