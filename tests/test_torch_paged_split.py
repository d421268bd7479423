"""The paged decode / verify kernel's plan and the serving engine's trimmed
block tables, on the CPU.

``plan_paged_split`` plans the split-S kernel of
``csrc/paged_attention.cu`` from the shapes alone; these tests hold it to
the rule the kernel's C guard enforces (spans of whole 64-key tiles,
splits covering S exactly once) and to the contiguous decode's plan at one
row group, which is what makes the paged bf16 decode bit-equal to
``decode_attention_contiguous`` through identity tables on the card.  The
serving engine hands its decode ticks and verifies block tables trimmed to
the pages its rows hold (``live_table_width``): a power of two at least
the largest row's page count, at most ``max_pages_per_seq``; trimming
changes no token.
"""

import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    Request,
    live_table_width,
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
    trimmed to its 4 pages split it into 8 of 192."""
    span, splits = pa.plan_paged_split(8, 4, 1, 64 * 512)
    assert (span, splits) == (3584, 10) and -(-1440 // span) == 1
    span, splits = pa.plan_paged_split(8, 4, 1, 4 * 512)
    assert (span, splits) == (192, 11) and -(-1440 // span) == 8


@pytest.mark.parametrize("max_pages", [1, 4, 7, 64])
def test_live_table_width_is_a_capped_power_of_two(max_pages):
    for held in range(0, max_pages + 1):
        width = live_table_width(held, max_pages)
        assert width <= max_pages
        assert width >= held
        if width < max_pages:
            assert width & (width - 1) == 0
            assert width < 2 * max(held, 1)


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
    """Wrap the engine's ``_live_tables``: every table it hands out, with
    the page count each row held, is recorded."""
    seen = []
    live = cb._live_tables

    def record(runs):
        tables = live(runs)
        seen.append((tables.copy(), {s.slot: len(s.pages) for s in runs}))
        return tables

    cb._live_tables = record
    return seen


def _full_width(cb):
    """The untrimmed tables: every slot's whole row of the engine's block
    tables (the rows of slots that are not running zeroed)."""

    def full(runs):
        tables = np.zeros_like(cb._block_tables)
        for s in runs:
            tables[s.slot] = cb._block_tables[s.slot]
        return tables

    cb._live_tables = full


PROMPTS = [list(range(2, 2 + n)) for n in (5, 30, 61, 12)]
SPEC = dict(speculative=True, spec_k=3, spec_ngram=2)


@pytest.mark.parametrize("spec", [{}, SPEC], ids=["decode", "verify"])
def test_serving_passes_trimmed_tables(spec):
    """Each decode tick (and verify) gets tables as wide as
    live_table_width of the largest page count its rows hold, each running
    row's pages in order, every other row zero."""
    cb = _engine(**spec)
    seen = _record_tables(cb)
    _serve(cb, PROMPTS, 6)
    assert seen
    widths = set()
    for tables, held in seen:
        width = live_table_width(max(held.values()), cb.max_pages_per_seq)
        assert tables.shape == (cb.max_slots, width)
        widths.add(width)
        for slot in range(cb.max_slots):
            if slot not in held:
                assert not tables[slot].any()
            else:
                n = held[slot]
                assert tables[slot, :n].all() and not tables[slot, n:].any()
    assert max(widths) < cb.max_pages_per_seq


@pytest.mark.parametrize("spec", [{}, SPEC], ids=["decode", "verify"])
def test_trimmed_tables_change_no_token(spec):
    """The same requests served with trimmed and with full-width tables
    give the same tokens and finish reasons."""
    trimmed = _serve(_engine(**spec), PROMPTS, 6)
    cb = _engine(**spec)
    _full_width(cb)
    assert _serve(cb, PROMPTS, 6) == trimmed
