"""The device mesh over ``torch.distributed``: ranks, groups, collectives.

The port's counterpart of the JAX package's ``parallel/mesh.py``.  The JAX
package has one controller that sees every device and runs the per-shard
body under ``shard_map``; the port is SPMD, one process a rank.  Every
rank runs the same engine code on its own shard and calls the collectives
explicitly on the mesh's groups:

* ``data`` (DP): independent batch rows, no collective inside a layer.
  The serving engine gathers a tick's logits over it and copies prefix
  pages between its groups (``gather_data`` / ``broadcast_data``);
* ``model`` (TP): weights and KV heads sharded, one all-reduce after each
  row-parallel projection (``o``, ``down``), the vocab-sharded embedding's
  sum and the sampler's gathers (``parallel/tp_step.TpLayout`` says which
  blocks split); the sequence-parallel prefill all-gathers tokens before
  the projections and reduce-scatters them after;
* ``ep`` (EP, its own mesh, ``make_ep_mesh``): serving slots and experts
  sharded over every rank of the world, tokens routed to the experts'
  ranks by two all-to-alls an MoE layer (``parallel/ep_moe.py``);
* ``stage`` (PP, its own mesh, ``make_pp_mesh``): the layers cut into
  consecutive stages, one a rank; the residual stream passes from stage
  to stage by ``ring_exchange`` (the JAX ``ppermute``) and the result
  leaves stage 0 by ``broadcast`` (``parallel/pp_step.py``).

``make_mesh((dp, tp))`` keeps ``model`` the inner axis, as the JAX mesh
does: rank ``r`` sits at ``(r // tp, r % tp)``, so a model group is ``tp``
consecutive ranks.  ``init_distributed`` takes the place of the JAX
package's ``initialize_multihost``, and ``spawn`` starts a world of local
processes over a ``file://`` rendezvous in a fresh temporary directory (no
fixed TCP port, so worlds started side by side never collide).

The backend follows the devices: NCCL where every rank has a card of its
own, gloo where ranks share a card or run on the CPU (``backend_for``).
The collectives used here (all-reduce, all-gather, broadcast and
``all_to_all_single`` with equal and with uneven splits) take CUDA tensors
under gloo in the card machine's PyTorch 2.11
(``scripts/probe_gloo_cuda_torch.py``), so no call stages through the
host itself; gloo runs them on the host all the same, and they cannot be
captured in a CUDA graph: ``Mesh.capturable`` is false, and the engines
take the eager step.  Gloo's point-to-point calls do not take CUDA
tensors there (``batch_isend_irecv`` aborts the rank: "writev ... Bad
address", the same probe), so ``ring_exchange`` runs as
``all_to_all_single`` with every split but the next stage's empty under
gloo, and as ``batch_isend_irecv`` under NCCL.

``all_reduce``, ``reduce_scatter``, ``all_gather``, ``all_to_all``,
``ring_exchange``,
``broadcast`` and the data axis's ``gather_data`` and ``broadcast_data``
count their calls in ``launches``, as the kernel wrappers do
(``utils/metrics.collective_wrappers``), so a captured step's replays
count the collectives inside its graph; all but ``all_reduce`` also count
the bytes this rank sends in ``sent_bytes``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
EP_AXIS = "ep"
STAGE_AXIS = "stage"

# how long a collective or the rendezvous waits for the other ranks
TIMEOUT = datetime.timedelta(seconds=1800)


@dataclasses.dataclass
class Group:
    """One axis of the mesh as this rank sees it: the process group, its
    size, this rank's index in it, its backend and the global ranks it
    holds (in index order)."""

    pg: Any
    size: int
    rank: int
    backend: str
    ranks: Tuple[int, ...]
    # a model group only: whether the TP step's row-parallel projections
    # (o, down) quantize their int8 activations with each token's scale
    # over the whole row (the per-token max all-reduced over the group), as
    # the JAX package's GSPMD runs do, or over this rank's own K, as its
    # ``shard_map`` TP step does (``parallel/tp_step.model_group``)
    whole_row_scales: bool = False
    # a model group only: the model's ``parallel/tp_step.TpLayout``, which
    # says which blocks split over the group (None: every block, evenly)
    layout: Any = None


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum"
               ) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place by ``op`` ("sum" or "max");
    returns ``t``."""
    all_reduce.launches += 1
    dist.all_reduce(t, op=(dist.ReduceOp.MAX if op == "max"
                           else dist.ReduceOp.SUM), group=group.pg)
    return t


def reduce_scatter(t: torch.Tensor, group: Group, dim: int = 0
                   ) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which this rank keeps slice
    ``group.rank`` of ``group.size`` equal slices along ``dim`` (the
    sequence-parallel prefill's sum over tokens): one
    ``reduce_scatter_tensor``."""
    reduce_scatter.launches += 1
    x = t.movedim(dim, 0).contiguous()
    reduce_scatter.sent_bytes += x.numel() * x.element_size()
    out = x.new_empty((x.shape[0] // group.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group.pg)
    return out.movedim(0, dim)


def _all_gather(counter, t: torch.Tensor, group: Group) -> torch.Tensor:
    counter.launches += 1
    t = t.contiguous()
    counter.sent_bytes += t.numel() * t.element_size()
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.pg)
    return torch.stack(parts)


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``[group.size, *t.shape]``: every rank's ``t`` in index order."""
    return _all_gather(all_gather, t, group)


def all_to_all(t: torch.Tensor, group: Group,
               send_sizes: Optional[List[int]] = None,
               recv_sizes: Optional[List[int]] = None) -> torch.Tensor:
    """Exchange row segments of ``t`` over ``group``: segment ``p`` goes to
    index ``p``, and the received segments come back to back in source
    order.  Without sizes every segment is ``t.shape[0] / group.size``
    rows (the equal-split form); with them (host ints, ``[group.size]``
    each) segment ``p`` of ``t`` has ``send_sizes[p]`` rows and the one
    from ``s`` ``recv_sizes[s]`` (the ragged form)."""
    all_to_all.launches += 1
    t = t.contiguous()
    all_to_all.sent_bytes += t.numel() * t.element_size()
    if send_sizes is None:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group.pg)
        return out
    out = t.new_empty((sum(recv_sizes),) + tuple(t.shape[1:]))
    dist.all_to_all_single(out, t, output_split_sizes=list(recv_sizes),
                           input_split_sizes=list(send_sizes),
                           group=group.pg)
    return out


def ring_exchange(t: torch.Tensor, group: Group,
                  src: Optional[int] = None) -> Optional[torch.Tensor]:
    """The pipeline's ``ppermute`` over ``group``'s ring: every index ``s``
    sends ``t`` to index ``s + 1`` (mod the size) and returns the tensor
    index ``s - 1`` sent, shaped as ``t``.  With ``src``, only index
    ``src`` sends (one hop): index ``src + 1`` returns what it sent, every
    other index None, and their ``t`` only gives the shape and type.
    Every rank of the group calls it, with tensors of one shape and type.
    Under NCCL a ``batch_isend_irecv``; under gloo (whose point-to-point
    calls take no CUDA tensor) one ``all_to_all_single`` with every split
    but the next index's empty."""
    ring_exchange.launches += 1
    n, me = group.size, group.rank
    nxt, prv = (me + 1) % n, (me - 1) % n
    send = src is None or src == me
    recv = src is None or (src + 1) % n == me
    t = t.contiguous()
    if n == 1:
        return t.clone() if recv else None
    if send:
        ring_exchange.sent_bytes += t.numel() * t.element_size()
    if group.backend == "nccl":
        out = torch.empty_like(t) if recv else None
        ops = ([dist.P2POp(dist.isend, t, group.ranks[nxt], group.pg)]
               if send else [])
        if recv:
            ops.append(dist.P2POp(dist.irecv, out, group.ranks[prv],
                                  group.pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out
    flat = t.reshape(-1)
    k = flat.numel()
    out = flat.new_empty(k if recv else 0)
    dist.all_to_all_single(
        out, flat if send else flat[:0],
        output_split_sizes=[k if recv and s == prv else 0 for s in range(n)],
        input_split_sizes=[k if send and p == nxt else 0 for p in range(n)],
        group=group.pg)
    return out.view(t.shape) if recv else None


def _broadcast(counter, t: torch.Tensor, group: Group,
               src: int) -> torch.Tensor:
    counter.launches += 1
    t = t.contiguous()
    if group.size > 1:
        if group.rank == src:
            counter.sent_bytes += t.numel() * t.element_size()
        dist.broadcast(t, src=group.ranks[src], group=group.pg)
    return t


def broadcast(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """``t`` of index ``src`` of ``group`` on every rank, in place (every
    other rank's ``t`` only gives the shape and type); returns ``t``."""
    return _broadcast(broadcast, t, group, src)


def gather_data(t: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
    """``all_gather`` over the data axis, counted apart: ``[dp,
    *t.shape]``, the ``t`` of every rank of this rank's data group (the
    ranks of its model index), in data-index order."""
    return _all_gather(gather_data, t, mesh.data_group)


def broadcast_data(t: torch.Tensor, mesh: "Mesh", src: int) -> torch.Tensor:
    """``broadcast`` over the data axis, counted apart: ``t`` of data index
    ``src`` (at this rank's model index) on every rank of the data group,
    in place; returns ``t``."""
    return _broadcast(broadcast_data, t, mesh.data_group, src)


all_reduce.launches = 0
reduce_scatter.launches = 0
reduce_scatter.sent_bytes = 0
all_gather.launches = 0
all_gather.sent_bytes = 0
all_to_all.launches = 0
all_to_all.sent_bytes = 0
ring_exchange.launches = 0
ring_exchange.sent_bytes = 0
broadcast.launches = 0
broadcast.sent_bytes = 0
gather_data.launches = 0
gather_data.sent_bytes = 0
broadcast_data.launches = 0
broadcast_data.sent_bytes = 0


def broadcast_object(obj, group: Group):
    """``obj`` of the group's first rank, on every rank of ``group`` (a
    pickled host message: the serving loop's control messages)."""
    box = [obj]
    dist.broadcast_object_list(box, src=group.ranks[0], group=group.pg)
    return box[0]


@dataclasses.dataclass
class Mesh:
    """A ``(data, model)`` mesh seen from one rank.  ``shape`` is the JAX
    mesh's ``{"data": dp, "model": tp}`` (the engines read ``dict(mesh.
    shape)``); ``coords`` this rank's ``(data, model)`` indices."""

    shape: Dict[str, int]
    rank: int
    coords: Tuple[int, int]
    model_group: Group
    data_group: Group
    world_group: Group

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def tp(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def dp(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def capturable(self) -> bool:
        """Whether a step with this mesh's collectives can be captured in a
        CUDA graph: NCCL collectives can, gloo's run on the host."""
        return self.model_group.backend == "nccl" and \
            self.data_group.backend == "nccl"


@dataclasses.dataclass
class EpMesh:
    """An expert-parallel ``("ep",)`` mesh seen from one rank: every rank
    of the world on one axis.  ``shape`` reads ``{"ep": P}``, as the JAX
    mesh's ``dict(mesh.shape)``; ``ep_group`` is the world as a ``Group``;
    ``ragged`` the all-to-all's form (``parallel/ep_moe.py``; None: ragged
    on the card, dense on the CPU)."""

    shape: Dict[str, int]
    rank: int
    ep_group: Group
    world_group: Group
    ragged: Optional[bool] = None

    @property
    def size(self) -> int:
        return self.shape[EP_AXIS]

    @property
    def ep(self) -> int:
        return self.shape[EP_AXIS]

    @property
    def capturable(self) -> bool:
        """False: an EP step cannot be captured in a CUDA graph.  Its
        ragged all-to-alls wait on the host once a layer for the split
        sizes, and ranks that share a card run gloo, whose collectives run
        on the host; the engines take eager steps."""
        return False


@dataclasses.dataclass
class PpMesh:
    """A pipeline-parallel ``("stage",)`` mesh seen from one rank: every
    rank of the world a stage, in rank order.  ``shape`` reads ``{"stage":
    S}``, as the JAX mesh's ``dict(mesh.shape)``; ``stage_group`` is the
    world as a ``Group``, its index this rank's stage."""

    shape: Dict[str, int]
    rank: int
    stage_group: Group
    world_group: Group

    @property
    def size(self) -> int:
        return self.shape[STAGE_AXIS]

    @property
    def stages(self) -> int:
        return self.shape[STAGE_AXIS]

    @property
    def stage(self) -> int:
        return self.stage_group.rank

    @property
    def backend(self) -> str:
        return self.stage_group.backend

    @property
    def capturable(self) -> bool:
        """False: a pipeline step is not captured in a CUDA graph.  Ranks
        that share a card run gloo, whose exchanges run on the host, and
        the schedulers take eager steps."""
        return False


def make_pp_mesh(n: Optional[int] = None) -> PpMesh:
    """This rank's view of a ``("stage",)`` mesh over the whole initialized
    world (the JAX package's ``make_pp_mesh``); ``n``, where given, must be
    the world's size.  Without a world, ``n = 1`` gives the mesh of one
    stage (nothing to exchange)."""
    if not dist.is_initialized():
        if n == 1:
            one = Group(pg=None, size=1, rank=0, backend="none", ranks=(0,))
            return PpMesh(shape={STAGE_AXIS: 1}, rank=0, stage_group=one,
                          world_group=one)
        raise RuntimeError("make_pp_mesh needs torch.distributed initialized "
                           "(init_distributed, or spawn)")
    world, me = dist.get_world_size(), dist.get_rank()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} stages needs {n} ranks, the world "
                         f"has {world}")
    group = Group(pg=dist.group.WORLD, size=world, rank=me,
                  backend=dist.get_backend(), ranks=tuple(range(world)))
    if group.backend == "nccl":
        # NCCL takes a batch of point-to-point calls from a subset of the
        # group (a one-hop exchange) only after a first collective of all
        dist.barrier()
    return PpMesh(shape={STAGE_AXIS: world}, rank=me, stage_group=group,
                  world_group=group)


def is_pp_mesh(mesh) -> bool:
    """Whether ``mesh`` has a ``stage`` axis above 1."""
    shape = getattr(mesh, "shape", None)
    return mesh is not None and shape is not None and \
        dict(shape).get(STAGE_AXIS, 1) > 1


def make_ep_mesh(ragged: Optional[bool] = None) -> EpMesh:
    """This rank's view of an ``("ep",)`` mesh over the whole initialized
    world (the JAX package's ``make_ep_mesh``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_ep_mesh needs torch.distributed initialized "
                           "(init_distributed, or spawn)")
    world, me = dist.get_world_size(), dist.get_rank()
    group = Group(pg=dist.group.WORLD, size=world, rank=me,
                  backend=dist.get_backend(), ranks=tuple(range(world)))
    return EpMesh(shape={EP_AXIS: world}, rank=me, ep_group=group,
                  world_group=group, ragged=ragged)


def is_ep_mesh(mesh) -> bool:
    """Whether ``mesh`` has an ``ep`` axis above 1 (the JAX package's
    ``is_ep_mesh``)."""
    shape = getattr(mesh, "shape", None)
    return mesh is not None and shape is not None and \
        dict(shape).get(EP_AXIS, 1) > 1


def make_mesh(shape: Tuple[int, int]) -> Mesh:
    """This rank's view of a ``(dp, tp)`` mesh over the initialized world,
    its groups on the world's backend.  Every rank of the world must call
    it, in the same order as its other group calls."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(init_distributed, or spawn)")
    world, me = dist.get_world_size(), dist.get_rank()
    dp, tp = shape
    if dp * tp != world:
        raise ValueError(f"mesh {shape} needs {dp * tp} ranks, the world "
                         f"has {world}")
    mine: Dict[str, Group] = {}
    # every rank creates every group (torch.distributed requires it), and
    # keeps the two it belongs to
    axes = [(MODEL_AXIS, [d * tp + m for m in range(tp)]) for d in range(dp)]
    axes += [(DATA_AXIS, [d * tp + m for d in range(dp)]) for m in range(tp)]
    for axis, ranks in axes:
        pg = dist.new_group(ranks)
        if me in ranks:
            mine[axis] = Group(pg=pg, size=len(ranks), rank=ranks.index(me),
                               backend=dist.get_backend(pg),
                               ranks=tuple(ranks))
    world_group = Group(pg=dist.group.WORLD, size=world, rank=me,
                        backend=dist.get_backend(), ranks=tuple(range(world)))
    return Mesh(shape={DATA_AXIS: dp, MODEL_AXIS: tp}, rank=me,
                coords=(me // tp, me % tp), model_group=mine[MODEL_AXIS],
                data_group=mine[DATA_AXIS], world_group=world_group)


def backend_for(world_size: int, device_type: str) -> str:
    """NCCL where every rank has a card of its own; gloo where ranks share
    a card (NCCL refuses two ranks on one device) or run on the CPU."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device of ``rank``: ``cuda:{rank % device_count}`` on the card,
    else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_distributed(backend: str, init_method: str, rank: int,
                     world_size: int,
                     device: Optional[torch.device] = None) -> None:
    """Join this process to a world (the JAX package's
    ``initialize_multihost``): the backend, the rendezvous address
    (``tcp://host:port`` or ``file://path``), this rank and the world
    size are given explicitly.  ``device`` (a card) becomes the current
    CUDA device first, as NCCL needs."""
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)


def _entry(rank: int, fn: Callable, world_size: int, backend: str,
           init_method: str, device_type: str, args: tuple,
           results) -> None:
    init_distributed(backend, init_method, rank, world_size,
                     rank_device(rank, device_type))
    try:
        out = fn(rank, world_size, *args)
        if results is not None:
            # by value: a tensor shared by handle dies with this process
            results.put((rank, pickle.dumps(out)))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *, device_type: str = "cpu",
          args: tuple = (), join: bool = True):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined into one world (``file://`` rendezvous in a fresh temporary
    directory; the backend from ``backend_for``).  ``fn`` must
    be importable by name (the processes are spawned, not forked).

    join=True waits for every rank and returns their return values in rank
    order; join=False returns the ``torch.multiprocessing`` context at
    once (the caller joins it and removes its ``rendezvous_dir``), with no
    results."""
    import queue

    import torch.multiprocessing as mp

    backend = backend_for(world_size, device_type)
    tmp = tempfile.mkdtemp(prefix="qie_rdv_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = mp.get_context("spawn").Queue() if join else None
    ctx = mp.spawn(_entry, args=(fn, world_size, backend, init_method,
                                 device_type, args, results),
                   nprocs=world_size, join=False)
    if not join:
        ctx.rendezvous_dir = tmp   # the caller removes it after joining
        return ctx
    got: List[Any] = [None] * world_size
    try:
        done = False
        while not done:
            # drain while waiting: a rank's result must not fill the pipe
            # its exit waits on
            done = ctx.join(timeout=0.05)
            while True:
                try:
                    rank, out = results.get_nowait()
                except queue.Empty:
                    break
                got[rank] = pickle.loads(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got
