"""The expert-parallel layout math and mesh of the port against the JAX
package: ``parallel/ep_layout.py`` integer-equal to the JAX functions on
the routings of ``tests/test_ep_layout.py`` (random, e_loc = 1, skewed to
one expert at full capacity, empty lanes, P = 1), with the receive side
fed the buffers a numpy simulation of the dispatch builds; the
``("ep",)`` mesh's gates (``is_ep_mesh``, ``supports_ep``) equal to the
JAX package's, and the EP refusals and the prefix cache's warning, each
naming its condition.  No world of ranks here."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.parallel import ep_layout as jl
from qwen_inference_engine_tpu.parallel import ep_step as jep
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.parallel import ep_layout as tl
from qwen_inference_engine_tpu_torch.parallel import ep_step as tep
from qwen_inference_engine_tpu_torch.parallel.mesh import (
    EpMesh,
    Group,
    is_ep_mesh,
)


def _random(P, e_loc, top_k, N, seed, allowed=None):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(P):
        pool = (range(P * e_loc) if allowed is None else allowed(s))
        out.append(np.stack([rng.choice(list(pool), top_k, replace=False)
                             for _ in range(N)]))
    return out


# (P, e_loc, top_k, per-device top-k choices)
CASES = {
    "random e_loc 1": (4, 1, 2, _random(4, 1, 2, 6, 1)),
    "random grouped experts": (4, 2, 3, _random(4, 2, 3, 5, 2)),
    "skewed to one expert, full capacity": (
        4, 2, 2, [np.zeros((4, 2), np.int64) for _ in range(4)]),
    "empty lanes": (4, 1, 2, _random(
        4, 1, 2, 6, 3, allowed=lambda s: [e for e in range(4)
                                          if e % 2 == s % 2])),
    "one device": (1, 4, 2, _random(1, 4, 2, 7, 4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layouts_are_the_jax_packages(case):
    """Every device's dispatch layout, every receiver's layout over the
    buffer the dispatch fills (source s at rows [s*M, s*M + n)) and the
    dense combine's gather indices: integer-equal to JAX's."""
    P, e_loc, top_k, topi = CASES[case]
    N = topi[0].shape[0]
    M = N * top_k
    lay = []
    for t in topi:
        want = [np.asarray(a) for a in jl.dispatch_layout(
            jnp.asarray(t), e_loc, P)]
        got = [a.numpy() for a in tl.dispatch_layout(torch.tensor(t),
                                                     e_loc, P)]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert got[3].dtype == got[4].dtype == np.int32
        lay.append(want)
    eid_col = np.full((P, P * M), -7.0, np.float32)   # garbage past sizes
    recv = np.zeros((P, P), np.int32)                 # [receiver, source]
    for s, (order, tok, eid_sorted, send, offs) in enumerate(lay):
        for d in range(P):
            n = send[d]
            eid_col[d, s * M:s * M + n] = (eid_sorted % e_loc)[offs[d]:
                                                              offs[d] + n]
            recv[d, s] = n
    for d in range(P):
        want = [np.asarray(a) for a in jl.receive_layout(
            jnp.asarray(eid_col[d]), jnp.asarray(recv[d]), M, e_loc)]
        got = [a.numpy() for a in tl.receive_layout(
            torch.from_numpy(eid_col[d]), torch.from_numpy(recv[d]), M,
            e_loc)]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert got[3].sum() == recv[d].sum()
    for order, tok, eid_sorted, send, offs in lay:
        want = np.asarray(jl.combine_gather_indices(
            jnp.asarray(eid_sorted), jnp.asarray(offs), M, e_loc))
        got = tl.combine_gather_indices(torch.tensor(eid_sorted),
                                        torch.tensor(offs), M, e_loc)
        np.testing.assert_array_equal(got.numpy(), want)


def fake_ep_mesh(ep: int, rank: int = 0) -> EpMesh:
    """An EP mesh object without a world: enough for the gates and the
    engines' constructors, which make no collective."""
    g = Group(pg=None, size=ep, rank=rank, backend="gloo",
              ranks=tuple(range(ep)))
    return EpMesh(shape={"ep": ep}, rank=rank, ep_group=g, world_group=g)


def test_ep_mesh_reads_like_the_jax_mesh():
    from jax.sharding import Mesh as JMesh

    mesh = fake_ep_mesh(4)
    jmesh = JMesh(np.asarray(jax.devices()[:4]), ("ep",))
    assert dict(mesh.shape) == dict(jmesh.shape) == {"ep": 4}
    assert is_ep_mesh(mesh) and jep.is_ep_mesh(jmesh)
    assert mesh.size == mesh.ep == 4 and not mesh.capturable
    assert not is_ep_mesh(None) and not is_ep_mesh(fake_ep_mesh(1))
    assert not is_ep_mesh(types.SimpleNamespace(shape={"data": 1,
                                                       "model": 2}))


@pytest.mark.parametrize("experts,ep,slots", [
    (8, 2, 4), (8, 4, 4), (8, 4, 6), (6, 4, 4), (0, 2, 4), (8, 1, 4)],
    ids=["e8 ep2", "e8 ep4", "slots 6 ep4", "e6 ep4", "dense", "ep1"])
def test_supports_ep_is_the_jax_gate(experts, ep, slots):
    from jax.sharding import Mesh as JMesh

    kw = (dict(num_experts=experts, num_experts_per_tok=2,
               moe_intermediate_size=64) if experts else {})
    jmesh = JMesh(np.asarray(jax.devices()[:ep]), ("ep",))
    want = jep.supports_ep(j_tiny_config(**kw), jmesh, slots)
    cfg = tiny_config(**kw)
    assert tep.supports_ep(cfg, fake_ep_mesh(ep), slots) == want
    why = tep.ep_refusal(cfg, fake_ep_mesh(ep), slots)
    assert (why is None) == want


MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64)


def _params(cfg):
    from qwen_inference_engine_tpu_torch.models.qwen import init_params

    return init_params(cfg, torch.Generator().manual_seed(0),
                       dtype=torch.float32)


@pytest.mark.parametrize("case,match", [
    ("dense model", "is not a MoE model"),
    ("experts", "6 experts do not split over ep=4"),
    ("slots", "max_slots=6 does not split over ep=4"),
])
def test_serving_refuses_what_the_jax_scheduler_runs_as_gspmd(case, match):
    """supports_ep false (the JAX scheduler then runs GSPMD's XLA ops)
    raises, naming why (an MoE drafter drafts by prompt lookup:
    tests/test_torch_ep_serving.py)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )

    cfg = tiny_config(**(MOE if case != "dense model" else {}))
    if case == "experts":
        cfg = tiny_config(**dict(MOE, num_experts=6))
    kw = dict(max_slots=6 if case == "slots" else 4, page_size=8,
              num_pages=16, max_pages_per_seq=4, device="cpu",
              prefix_cache=False)
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(cfg, _params(cfg), mesh=fake_ep_mesh(4),
                                 **kw)


def test_engine_under_an_ep_mesh_is_refused():
    """``Engine`` (generate) under an EP mesh: the JAX engine raises there
    too (``NamedSharding(mesh, P("data"))`` on a mesh with no data axis:
    ``tests/test_torch_parallel_sharding.py``); EP is served."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine

    cfg = tiny_config(**MOE)
    with pytest.raises(NotImplementedError, match="expert-parallel mesh: "
                                                  "the JAX Engine raises.*"
                                                  "no data axis.*serve --ep"):
        Engine(cfg, _params(cfg), mesh=fake_ep_mesh(2), max_batch=2,
               max_seq=64, kv_dtype=torch.float32, device="cpu")


def test_prefix_cache_is_switched_off_with_a_warning():
    """As the JAX scheduler: a rank holds only its own slots' KV, so the
    prefix cache is off under the EP mesh; the engine takes its experts
    (E / ep of each stack) and eager steps."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )

    cfg = tiny_config(**MOE)
    params = _params(cfg)
    with pytest.warns(UserWarning, match="prefix cache disabled under the "
                                         "EP mesh"):
        cb = ContinuousBatchingEngine(cfg, params, mesh=fake_ep_mesh(2, 1),
                                      max_slots=4, page_size=8, num_pages=16,
                                      max_pages_per_seq=4, device="cpu")
    assert not cb.prefix_cache and not cb.graphs.capture
    got = cb.params["layers"]["moe_gate"]
    want = params["layers"]["moe_gate"][:, 4:]
    assert torch.equal(got, want)
    assert cb.params["layers"]["q"].w is params["layers"]["q"].w
    assert [cb._owns(s) for s in range(4)] == [False, False, True, True]
    assert cb._ep_scratch.pool.k_pages.shape[1] == 4
