"""Expert-parallel MoE layer: tokens routed to the experts' ranks through
two all-to-alls.

The port of the JAX package's ``parallel/ep_moe.py``.  Each rank of the
expert-parallel group holds its own tokens ``h [N_loc, D]``, the router
whole and its ``E / P`` experts (rank ``p`` holds experts ``[p * e_loc,
(p + 1) * e_loc)``).  One layer:

1. route exactly as ``models/qwen.moe_mlp`` does (f32 router logits,
   softmax, top-k, optional renormalization), and sort this rank's
   ``M = N_loc * top_k`` (token, expert) pairs by global expert, so each
   destination's rows are one segment (``ep_layout.dispatch_layout``);
2. all-gather the ``[2, P]`` sizes and offsets of every rank;
3. dispatch the rows, the local-expert id riding as one extra column in
   the activation dtype, into a ``[P * M]``-row receive buffer where
   source ``s`` owns rows ``[s * M, s * M + recv_sizes[s])``;
4. sort the received rows by local expert (``ep_layout.receive_layout``)
   and run the three grouped products over them;
5. un-sort, send each row back to its source, and sum each token's
   ``top_k`` weighted rows in f32 in dispatch order (``index_copy_``, then
   a sum over the pairs: no atomics, so the bits do not depend on the run).

Two forms of the exchange, as the JAX package's ``ragged`` flag:

* ragged: exact-size ``all_to_all`` with split sizes, read on the host once
  a layer after the metadata gather; the packed segments are scattered
  into the buffer layout above, and the return trip carries only the
  real rows, which come back in the sender's sorted order;
* dense: equal splits of ``M`` rows a peer (each segment padded with
  zeros to capacity), no host read; the return trip is gathered back into
  dispatch order with ``ep_layout.combine_gather_indices``.

``ragged=None`` takes the ragged form on a CUDA tensor and the dense form
on the CPU.  Both forms fill the receive buffer alike, so they give the
same bits.  Only ``sum(gs)`` rows of the buffer are real: the grouped
kernels never compute the rows past the last group, and nothing reads
them (the dense return trip sends zeros in their place).

Exact routing, no capacity factor: the buffers hold the worst case (every
pair to one rank), so the grouping is the single-card ``moe_mlp``'s.  A
layer makes one ``all_gather`` and two ``all_to_all`` calls; the dispatch
sends ``M * (D + 1)`` activation elements, the combine ``M * D`` (the dense
form ``P`` times as many).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from qwen_inference_engine_tpu_torch.ops.grouped_matmul import (
    grouped_matmul_dense,
    grouped_quant_matmul,
    grouped_quant_matmul_supported,
)
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, dequantize
from qwen_inference_engine_tpu_torch.parallel.ep_layout import (
    combine_gather_indices,
    dispatch_layout,
    receive_layout,
)
from qwen_inference_engine_tpu_torch.parallel.mesh import (
    Group,
    all_gather,
    all_to_all,
)

# the largest local-expert id the payload's id column holds exactly
ID_CAP = {torch.bfloat16: 256, torch.float16: 2048}


def _expert_compute(xs: torch.Tensor, w_gate, w_up, w_down,
                    group_sizes: torch.Tensor, layer: int,
                    act_bits: int = 0) -> torch.Tensor:
    """The grouped gate / up / SiLU / down over rows sorted by local expert
    (the JAX ``_expert_compute``): layer-stacked ``[L, E_loc, K, N]``
    shards, bf16 or quantized.  A quantized shard takes the grouped
    kernels, with ``act_bits`` as given, where the JAX shape gate holds
    for both ``w_gate`` and ``w_down``; otherwise the layer's shard is
    dequantized and runs the bf16 stacks' path (``grouped_matmul_dense``,
    the JAX package's ``ragged_dot``)."""
    n, k = xs.shape
    if isinstance(w_gate, QuantLinear):
        if (grouped_quant_matmul_supported(w_gate, n)
                and grouped_quant_matmul_supported(w_down, n)):
            g = grouped_quant_matmul(xs, w_gate, group_sizes, layer,
                                     act_bits=act_bits)
            u = grouped_quant_matmul(xs, w_up, group_sizes, layer,
                                     act_bits=act_bits)
            mid = F.silu(g.float()) * u.float()
            return grouped_quant_matmul(mid.to(xs.dtype), w_down,
                                        group_sizes, layer,
                                        act_bits=act_bits)

        def dq(w, width):
            return dequantize(QuantLinear(
                q=w.q[layer], scales=w.scales[layer], b=None, bits=w.bits,
                group_size=w.group_size))[:, :width, :]

        w_gate, w_up = dq(w_gate, k), dq(w_up, k)
        w_down = dq(w_down, w_gate.shape[-1])
    else:
        w_gate, w_up, w_down = w_gate[layer], w_up[layer], w_down[layer]
    g = grouped_matmul_dense(xs, w_gate.to(xs.dtype), group_sizes)
    u = grouped_matmul_dense(xs, w_up.to(xs.dtype), group_sizes)
    mid = F.silu(g.float()) * u.float()
    return grouped_matmul_dense(mid.to(xs.dtype), w_down.to(xs.dtype),
                                group_sizes)


def ep_moe_layer(h: torch.Tensor, router: torch.Tensor, w_gate, w_up,
                 w_down, top_k: int, norm_topk: bool, group: Group, *,
                 ragged: Optional[bool] = None, layer: int = 0,
                 act_bits: int = 0) -> torch.Tensor:
    """One expert-parallel MoE layer on this rank: ``h [N_loc, D]`` -> the
    same shape.

    router ``[D, E]`` whole; w_gate / w_up ``[L, E_loc, D, Fm]`` and w_down
    ``[L, E_loc, Fm, D]`` this rank's experts (bf16 stacks or quantized),
    ``layer`` the slab; ``group`` the expert-parallel group
    (``parallel/mesh.Group``), every rank of which calls this at once.
    ``ragged``: the exchange's form (module docstring)."""
    if ragged is None:
        ragged = h.device.type == "cuda"
    P, me = group.size, group.rank
    N, D = h.shape
    E = router.shape[-1]
    e_loc = (w_gate.q if isinstance(w_gate, QuantLinear) else w_gate).shape[1]
    if e_loc * P != E:
        raise ValueError(f"{e_loc} local experts x {P} ranks != {E} experts")
    cap = ID_CAP.get(h.dtype, 1 << 24)
    if e_loc > cap:
        raise ValueError(f"{e_loc} local experts exceed the exactly "
                         f"representable id range of the {h.dtype} payload "
                         f"column ({cap})")

    # 1. route (moe_mlp's math)
    logits = h.float() @ router.to(h.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)            # [N, k]
    if norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    M = N * top_k
    order, tok, eid_sorted, send_sizes, input_offs = dispatch_layout(
        topi, e_loc, P)

    # 2. every rank's (send_sizes, input_offs)
    metag = all_gather(torch.stack([send_sizes, input_offs]), group)
    recv_sizes = metag[:, 0, me]                             # [P]

    # 3. dispatch: rows ++ local-expert id
    payload = torch.cat([h.index_select(0, tok),
                         (eid_sorted % e_loc).to(h.dtype)[:, None]], dim=-1)
    if ragged:
        sizes = metag.tolist()                # the host read of the layer
        send_n = sizes[me][0]
        recv_n = [sizes[s][0][me] for s in range(P)]
        packed = all_to_all(payload, group, send_n, recv_n)
        recv = payload.new_zeros((P * M, D + 1))
        off = 0
        for s, n in enumerate(recv_n):
            recv[s * M:s * M + n] = packed[off:off + n]
            off += n
    else:
        pi = torch.arange(P * M, device=h.device)
        dst, i = pi // M, pi % M
        src = (input_offs.long()[dst] + i).clamp(max=M - 1)
        ok = i < send_sizes.long()[dst]
        buf = torch.where(ok[:, None], payload.index_select(0, src),
                          torch.zeros((), dtype=h.dtype, device=h.device))
        recv = all_to_all(buf, group)

    # 4. the grouped products over the rows sorted by local expert
    valid, _, order2, gs = receive_layout(recv[:, D], recv_sizes, M, e_loc)
    y2 = _expert_compute(recv[:, :D].index_select(0, order2), w_gate, w_up,
                         w_down, gs, layer, act_bits)
    y_rx = torch.empty_like(y2).index_copy_(0, order2, y2)

    # 5. back to the sources, then the weighted combine
    if ragged:
        seg = torch.cat([y_rx[s * M:s * M + n] for s, n in enumerate(recv_n)])
        y_sorted = all_to_all(seg, group, recv_n, send_n)    # sorted order
    else:
        back = all_to_all(torch.where(valid[:, None], y_rx,
                                      torch.zeros((), dtype=y_rx.dtype,
                                                  device=h.device)), group)
        y_sorted = back.index_select(
            0, combine_gather_indices(eid_sorted, input_offs, M, e_loc))
    contrib = y_sorted * topw.reshape(-1)[order].to(y_sorted.dtype)[:, None]
    rows = torch.empty_like(contrib).index_copy_(0, order, contrib)
    return rows.view(N, top_k, -1).float().sum(dim=1).to(h.dtype)
