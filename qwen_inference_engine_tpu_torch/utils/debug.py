"""Debug dump hooks: activations, top logits and KV rows, printed.

The port of the JAX package's ``utils/debug.py``, with its fields and
their numpy formatting.  Each hook returns its input unchanged, so it can
stay in a code path; it prints only after ``enable()``.  The JAX hooks
print from inside a jitted step at run time (``jax.debug.print``); a host
print cannot run inside a replayed CUDA graph, so an enabled hook raises
while a stream is capturing (a captured decode step of
``engine/step_graph.py``): run such steps under
``step_graph.eager_steps()`` to see the prints.  Neither package calls
these hooks on its own path.
"""

from __future__ import annotations

import torch

_ENABLED = [False]


def enable(on: bool = True) -> None:
    """Turn the dump hooks on or off for the whole process."""
    _ENABLED[0] = on


def _active(tag: str) -> bool:
    """Whether a hook prints: enabled, and not under a CUDA graph capture
    (which raises)."""
    if not _ENABLED[0]:
        return False
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"debug hook {tag!r}: a host print cannot run inside a captured "
            f"CUDA graph; run the step under step_graph.eager_steps() (or "
            f"disable the hooks with utils.debug.enable(False))")
    return True


def dump_activation(tag: str, x: torch.Tensor, n: int = 10) -> torch.Tensor:
    """Print the first ``n`` values (flattened), the mean and the absmax of
    ``x``; returns ``x``."""
    if not _active(tag):
        return x
    xf = x.detach().float()
    head = xf.reshape(-1)[:n].cpu().numpy()
    print(f"{tag}: head={head} mean={xf.mean().item():.6f} "
          f"absmax={xf.abs().max().item():.6f}", flush=True)
    return x


def dump_top_logits(tag: str, logits: torch.Tensor, k: int = 5
                    ) -> torch.Tensor:
    """Print the top-``k`` ids and values of each row; returns ``logits``."""
    if not _active(tag):
        return logits
    vals, idx = torch.topk(logits.detach().float(), k, dim=-1)
    print(f"{tag}: top{k} ids={idx.cpu().numpy()} "
          f"vals={vals.cpu().numpy()}", flush=True)
    return logits


def dump_kv_rows(tag: str, cache_layer: torch.Tensor, batch: int, head: int,
                 start: int, count: int) -> torch.Tensor:
    """Print the first 4 dims of KV rows ``[start, start + count)`` of
    (``batch``, ``head``) of a head-major ``[B, Hk, S, D]`` layer slice;
    returns ``cache_layer``.  A window past the end is moved back inside,
    as ``jax.lax.dynamic_slice_in_dim`` moves it."""
    if not _active(tag):
        return cache_layer
    lo = min(max(start, 0), cache_layer.shape[2] - count)
    rows = cache_layer[batch, head, lo:lo + count, :4].detach().float()
    print(f"{tag}: kv[{batch},{head},{start}:{start + count}] "
          f"firstdims={rows.cpu().numpy()}", flush=True)
    return cache_layer
