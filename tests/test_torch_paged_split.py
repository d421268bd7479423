"""The paged decode / verify kernel's plan and the serving engine's block
tables, on the CPU.

``plan_paged_split`` plans the split-S kernel of
``csrc/paged_attention.cu`` from the shapes alone; these tests hold it to
the rule the kernel's C guard enforces (spans of whole 64-key tiles,
splits covering S exactly once) and to the contiguous decode's plan at one
row group, which is what makes the paged bf16 decode bit-equal to
``decode_attention_contiguous`` through identity tables on the card.  The
serving engine hands its decode ticks and verifies block tables of its
full ``max_pages_per_seq`` width (``_run_tables``), so the plan, and a
row's output, never follows the pages its neighbours hold.
"""

import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    Request,
)
from qwen_inference_engine_tpu_torch.models.qwen import init_params
from qwen_inference_engine_tpu_torch.ops import decode_attention as da
from qwen_inference_engine_tpu_torch.ops import paged_attention as pa
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

CFG = tiny_config()
PARAMS = init_params(CFG, torch.Generator().manual_seed(42),
                     dtype=torch.float32)


@pytest.mark.parametrize("T,G", [(1, 1), (1, 7), (1, 8), (2, 7), (5, 7),
                                 (9, 7), (10, 7), (16, 4), (17, 4), (9, 8),
                                 (17, 8)])
def test_paged_row_groups_pack_64_rows(T, G):
    """One row group while the T * G packed rows fit a block of 64 (every
    decode, the verify up to T = 9 at G = 7), else ceil(T * G / 64)."""
    groups = pa.paged_row_groups(T, G)
    assert groups == -(-T * G // 64)
    assert (groups == 1) == (T * G <= 64)
    assert (groups - 1) * pa.GROUP_ROWS < T * G <= groups * pa.GROUP_ROWS


@pytest.mark.parametrize("S", [8, 24, 64, 512, 1000, 2048, 2304, 32768])
@pytest.mark.parametrize("T,G", [(1, 7), (5, 7), (10, 7), (17, 8)])
def test_plan_paged_split_follows_the_kernel_guard(S, T, G):
    """For any batch and KV head count: a span of whole 64-key tiles,
    splits covering S exactly once (the C guard's bad_plan, which
    check_split_plan mirrors), enough blocks to fill the card where S has
    the tiles for it, and at one row group the contiguous decode's plan."""
    groups = pa.paged_row_groups(T, G)
    for B in (1, 4, 8, 192):
        for Hk in (2, 4, 8):
            span, splits = pa.plan_paged_split(B, Hk, groups, S)
            da.check_split_plan("plan", span, splits, S)
            assert span > 0 and span % da.SPLIT_KEYS == 0
            assert (splits - 1) * span < S <= splits * span
            assert (B * Hk * groups * splits >= da.SPLIT_TARGET_BLOCKS
                    or span == da.SPLIT_KEYS)
            if groups == 1:
                assert (span, splits) == da.plan_decode_split(B, Hk, S)


def test_plan_paged_split_at_serving_width():
    """Serving's 8 slots of the 7B (Hk 4): tables of the default width (64
    pages of 512) put the 1440-key row into one split of 3584 keys; tables
    of its 4 pages would split it into 8 of 192."""
    span, splits = pa.plan_paged_split(8, 4, 1, 64 * 512)
    assert (span, splits) == (3584, 10) and -(-1440 // span) == 1
    span, splits = pa.plan_paged_split(8, 4, 1, 4 * 512)
    assert (span, splits) == (192, 11) and -(-1440 // span) == 8


def _engine(**kw):
    base = dict(max_slots=3, page_size=8, num_pages=64, max_pages_per_seq=32,
                sampling=SamplingParams(greedy=True),
                kv_dtype=torch.float32, device="cpu")
    base.update(kw)
    return ContinuousBatchingEngine(CFG, PARAMS, **base)


def _serve(cb, prompts, new_tokens):
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=new_tokens))
    done = cb.run_to_completion(sync_every=4)
    cb.check_page_invariants()
    return {f.request_id: (f.token_ids, f.finish_reason) for f in done}


def _record_tables(cb):
    """Wrap the engine's ``_run_tables``: every table it hands out, with
    the page count each row held, is recorded."""
    seen = []
    run_tables = cb._run_tables

    def record(runs):
        tables = run_tables(runs)
        seen.append((tables.copy(), {s.slot: len(s.pages) for s in runs}))
        return tables

    cb._run_tables = record
    return seen


PROMPTS = [list(range(2, 2 + n)) for n in (5, 30, 61, 12)]
SPEC = dict(speculative=True, spec_k=3, spec_ngram=2)
KV = [torch.float32, torch.int8]


@pytest.mark.parametrize("kv", KV, ids=["f32", "int8"])
@pytest.mark.parametrize("spec", [{}, SPEC], ids=["decode", "verify"])
def test_serving_passes_full_width_tables(spec, kv):
    """Each decode tick (and verify) gets tables of the engine's full
    max_pages_per_seq width, however few pages its rows hold: each
    running row's pages in order, every other row zero."""
    cb = _engine(kv_dtype=kv, **spec)
    seen = _record_tables(cb)
    _serve(cb, PROMPTS, 6)
    assert seen
    for tables, held in seen:
        assert tables.shape == (cb.max_slots, cb.max_pages_per_seq)
        for slot in range(cb.max_slots):
            if slot not in held:
                assert not tables[slot].any()
            else:
                n = held[slot]
                assert tables[slot, :n].all() and not tables[slot, n:].any()
    most = max(max(held.values()) for _, held in seen)
    assert len({max(held.values()) for _, held in seen}) > 1
    assert most < cb.max_pages_per_seq


@pytest.mark.parametrize("kv", KV, ids=["f32", "int8"])
@pytest.mark.parametrize("spec", [{}, SPEC], ids=["decode", "verify"])
def test_row_tokens_do_not_follow_neighbours(spec, kv):
    """One request served alone, beside short neighbours and beside long
    ones gives the same tokens and finish reason."""
    probe = PROMPTS[0]
    runs = [_serve(_engine(kv_dtype=kv, **spec), [probe] + others, 6)[0]
            for others in ([], PROMPTS[1:], [list(range(3, 64))] * 2)]
    assert runs[0] == runs[1] == runs[2]
