"""Carry a parameter tree of the JAX package over to the port.

``params_from_numpy`` takes the JAX package's parameter pytree after each
leaf was converted with ``np.asarray`` (the caller does the conversion, so
this module imports no JAX) and returns the port's params: the same dict
layout, with the port's ``Linear`` / ``QuantLinear`` holding torch tensors.
The packed INT4 bytes and scales are carried as they are, so both packages
compute the same function.  Linears are recognised by their fields
(``w``/``b`` or ``q``/``scales``/``bits``/``group_size``), not their class.

``paged_cache_from_numpy`` does the same for the JAX package's
``PagedKVCache`` (its array fields as numpy): the port's ``PagedKVCache``
with the same pool ``[L, P, Hk, page, D]``, scales and page size, so both
packages can start from one pool.
"""

from __future__ import annotations

import numpy as np

from qwen_inference_engine_tpu_torch.kvcache.cache import PagedKVCache
from qwen_inference_engine_tpu_torch.loader.convert import as_tensor
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear


def _tensor(a, device):
    """A torch copy of a numpy leaf; bf16 (``ml_dtypes.bfloat16``, the JAX
    package's default dtype, which ``torch.from_numpy`` rejects) is carried
    bit for bit through a ``uint16`` view (``loader/convert.as_tensor``)."""
    if a is None:
        return None
    return as_tensor(np.array(a, copy=True)).to(device)


def _leaf(v, device):
    if hasattr(v, "q") and hasattr(v, "scales"):
        return QuantLinear(q=_tensor(v.q, device),
                           scales=_tensor(v.scales, device),
                           b=_tensor(v.b, device), bits=int(v.bits),
                           group_size=int(v.group_size))
    if hasattr(v, "w"):
        return Linear(w=_tensor(v.w, device), b=_tensor(v.b, device))
    if isinstance(v, dict):
        return {k: _leaf(x, device) for k, x in v.items()}
    return _tensor(v, device)


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """The port's params from a numpy-leaved JAX parameter tree."""
    return {k: _leaf(v, device) for k, v in tree.items()}


def paged_cache_from_numpy(cache, device="cpu") -> PagedKVCache:
    """The port's paged cache from a JAX ``PagedKVCache`` whose arrays were
    converted with ``np.asarray`` (fields ``k_pages``, ``v_pages``,
    ``k_scale``, ``v_scale``, ``page_size``; matched by name)."""
    return PagedKVCache(k_pages=_tensor(cache.k_pages, device),
                        v_pages=_tensor(cache.v_pages, device),
                        k_scale=_tensor(cache.k_scale, device),
                        v_scale=_tensor(cache.v_scale, device),
                        page_size=int(cache.page_size))
