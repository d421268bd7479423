"""Send / receive layout of the expert-parallel MoE all-to-alls.

The port of the JAX package's ``parallel/ep_layout.py``: the offsets and
sizes around the dispatch and combine exchanges of ``ep_moe.ep_moe_layer``,
as integer tensors on the device.  No collectives here.

Buffer contract (``ep_moe.ep_moe_layer``'s):

* every rank contributes ``M = N_loc * top_k`` (token, expert) pairs;
* the dispatch receive buffer has ``P * M`` rows, partitioned by source:
  source ``s`` owns rows ``[s * M, s * M + recv_sizes[s])``;
* the combine returns each received segment to its source, which sees its
  rows back in its sorted dispatch order.

Sorts are stable (``torch.argsort(stable=True)``, as JAX's ``argsort``),
and the sizes are counted with ``scatter_add_`` on the device: CUDA's
``bincount`` reads its input's max on the host.
"""

from __future__ import annotations

import torch


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ``[n]``: how many of ``ids`` (in ``[0, n)``) take each value."""
    out = torch.zeros(n, dtype=torch.int32, device=ids.device)
    return out.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))


def dispatch_layout(topi: torch.Tensor, e_loc: int, P: int):
    """Sender-side layout from the router's top-k choices ``topi [N, top_k]``
    (global expert ids).  Returns

    * ``order [M]``: the stable permutation sorting the pairs by global
      expert, so by destination rank (rank ``p`` holds experts
      ``[p * e_loc, (p + 1) * e_loc)``);
    * ``tok [M]``: the source token of each sorted pair;
    * ``eid_sorted [M]``: the global expert of each sorted pair;
    * ``send_sizes [P]`` (int32): the rows bound for each rank;
    * ``input_offs [P]`` (int32): where each rank's segment starts in the
      sorted payload (the exclusive cumsum of ``send_sizes``).
    """
    top_k = topi.shape[-1]
    flat_e = topi.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    tok = order // top_k
    eid_sorted = flat_e[order]
    send_sizes = _counts(flat_e, e_loc * P).view(P, e_loc).sum(
        -1, dtype=torch.int32)
    input_offs = (torch.cumsum(send_sizes, 0, dtype=torch.int32)
                  - send_sizes)
    return order, tok, eid_sorted, send_sizes, input_offs


def receive_layout(eid_col: torch.Tensor, recv_sizes: torch.Tensor, M: int,
                   e_loc: int):
    """Receiver-side layout over the ``[P * M]``-row dispatch buffer.

    ``eid_col [P * M]``: the local-expert-id column of the payload (garbage
    on rows past each source's ``recv_sizes``).  Returns

    * ``valid [P * M]``: the row lies in its source's received segment;
    * ``eid_rx [P * M]``: its local expert, ``e_loc`` where not valid;
    * ``order2 [P * M]``: the stable permutation grouping the valid rows by
      local expert (the others sort to the end);
    * ``gs [e_loc]`` (int32): rows per local expert, the grouped matmuls'
      group sizes.
    """
    PM = eid_col.shape[0]
    rr = torch.arange(PM, device=eid_col.device)
    src = rr // M
    valid = (rr - src * M) < recv_sizes.long()[src]
    eid_rx = torch.where(valid, eid_col.long(),
                         torch.full_like(rr, e_loc))
    order2 = torch.argsort(eid_rx, stable=True)
    gs = _counts(eid_rx, e_loc + 1)[:e_loc]
    return valid, eid_rx, order2, gs


def combine_gather_indices(eid_sorted: torch.Tensor,
                           input_offs: torch.Tensor, M: int,
                           e_loc: int) -> torch.Tensor:
    """The dense form's combine: after the equal-split all-to-all returns
    buffer row ``p * M + i`` = row ``i`` of my segment to rank ``p``, these
    indices gather the buffer back into my sorted dispatch order."""
    r = torch.arange(M, device=eid_sorted.device)
    dst_r = eid_sorted // e_loc
    return dst_r * M + (r - input_offs.long()[dst_r])
