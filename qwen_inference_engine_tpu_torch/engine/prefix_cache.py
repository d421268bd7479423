"""Page pool + automatic prefix cache (mixin of ContinuousBatchingEngine).

The port of the JAX package's ``engine/prefix_cache.py``: host-side page
accounting (free list, refcounts, an LRU pool of parked registered pages)
and the page-granular, hash-chained prefix index with sub-page tail
sharing through a partial-page copy.  The copy is plain torch
(``PagedKVCache.copy_page``), as it was XLA in the JAX package.

Under a data axis each data group writes only its own slots' pages into
its pool, while the prefix index is every rank's host state.  ``_held``
records, for each page in use or parked, the groups that hold its content
(the writer's group from allocation on); a page leaves it when it returns
to the free list.  Before a slot of group ``g`` reads a hit page, or a
partial-tail source, that ``g`` does not hold, ``_share_pages`` broadcasts
the page over the data axis (``parallel/mesh.broadcast_data``) from the
lowest group that holds it into the same page id on every group, all
layers, with the INT8 scales and the drafter's pool: a collective that
the host state decides, never a host round trip of KV.  Page ids and hit
counts stay the one-rank scheduler's.

State lives on the engine (``self._free_pages``, ``self._prefix_index``,
...); this class only groups the page and prefix logic.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from qwen_inference_engine_tpu_torch.engine.types import _Running
from qwen_inference_engine_tpu_torch.parallel.mesh import broadcast_data


class PagePoolMixin:
    # ---------------- prefix-cache page accounting --------------------
    def _alloc_page(self) -> int:
        """Pop a content-free page, evicting the LRU ref-0 cached page only
        when the free list is dry (a registered prefix stays reusable for
        as long as the pool is not needed for live work)."""
        if self._free_pages:
            return self._free_pages.pop()
        page, h = self._cached_free.popitem(last=False)
        parent = self._prefix_index[h][1]
        kids = self._prefix_children.get(parent)
        if kids is not None:
            kids.pop(page, None)
            if not kids:
                del self._prefix_children[parent]
        del self._prefix_index[h]
        del self._page_hash[page]
        if self._held is not None:
            self._held.pop(page, None)
        return page

    def _page_budget(self) -> int:
        return len(self._free_pages) + len(self._cached_free)

    def _release_page(self, page: int) -> None:
        self._page_refs[page] = self._page_refs.get(page, 1) - 1
        if self._page_refs[page] > 0:
            return
        del self._page_refs[page]
        h = self._page_hash.get(page)
        if h is not None:
            self._cached_free[page] = h     # parked, evictable LRU
        else:
            self._free_pages.append(page)
            if self._held is not None:
                self._held.pop(page, None)

    def _share_pages(self, pages: List[int], group: int) -> None:
        """Make data group ``group`` hold ``pages``: those it does not hold
        are broadcast over the data axis from the lowest group that holds
        each (one packed broadcast a source group: k, v, the INT8 scales,
        the drafter's pool), into the same page ids on every group, which
        then all hold them."""
        by_src: Dict[int, List[int]] = {}
        for p in pages:
            held = self._held[p]
            if not held >> group & 1:
                by_src.setdefault((held & -held).bit_length() - 1,
                                  []).append(p)
        every = (1 << self._dpm.dp) - 1
        for src, ps in sorted(by_src.items()):
            ids = torch.tensor(ps, device=self.device)
            leaves = [t for pool in (self.cache, self.draft_cache)
                      if pool is not None
                      for t in (pool.k_pages, pool.v_pages, pool.k_scale,
                                pool.v_scale) if t is not None]
            parts = [t.index_select(1, ids) for t in leaves]
            buf = broadcast_data(torch.cat(
                [x.reshape(-1).view(torch.uint8) for x in parts]),
                self._dpm, src)
            off = 0
            for t, x in zip(leaves, parts):
                n = x.numel() * x.element_size()
                t.index_copy_(1, ids, buf[off:off + n].view(x.dtype)
                              .view(x.shape))
                off += n
            for p in ps:
                self._held[p] = every
            self.pages_shared += len(ps)

    def _prefix_lookup(self, prompt: List[int]):
        """Longest chain of registered pages matching the prompt's leading
        full pages (capped at prompt-1 tokens so at least one token always
        runs through prefill: the last token's logits must be computed).
        Returns (hit pages, chain hash where the match stopped)."""
        ps = self.page_size
        hits: List[int] = []
        parent = None
        for i in range((len(prompt) - 1) // ps):
            blk = tuple(prompt[i * ps: (i + 1) * ps])
            h = hash((parent, blk))
            entry = self._prefix_index.get(h)
            # parent + content verified: equal chain hashes then imply equal
            # whole-prefix content by induction (no silent collision sharing)
            if entry is None or entry[1:] != (parent, blk):
                break
            hits.append(entry[0])
            parent = h
        return hits, parent

    def _partial_lookup(self, prompt: List[int], n_hits: int, parent):
        """Best PARTIAL continuation of the matched chain: a registered
        child page of ``parent`` (full page or sub-page tail) whose leading
        rows match the prompt's tail.  Returns (source page, matched token
        count) or (None, 0).  The match is content-verified row by row."""
        ps = self.page_size
        rest = prompt[n_hits * ps:]
        # leave at least one prompt token for prefill
        cap = min(len(prompt) - 1 - n_hits * ps, ps)
        best_page, best_t = None, 0
        for page, blk in self._prefix_children.get(parent, {}).items():
            t = 0
            for a, b in zip(blk, rest[:cap]):
                if a != b:
                    break
                t += 1
            if t > best_t:
                best_page, best_t = page, t
        return best_page, best_t

    def _copy_page(self, src: int, dst: int) -> None:
        """One whole-page KV copy (src page -> dst page, all layers).  Rows
        past the partial match are stale, but prefill overwrites any row
        before attention can read it (positions >= prefilled are never
        attended until written).  A drafter's pool mirrors the target's
        page ids, so it copies the same page."""
        self.cache.copy_page(src, dst)
        if self.draft_cache is not None:
            self.draft_cache.copy_page(src, dst)

    def _register_pages(self, run: _Running) -> None:
        """On completion, register this run's full-content pages so future
        prompts sharing the prefix (its generated tokens included: the
        multi-turn chat pattern) skip their prefill."""
        ps = self.page_size
        # KV actually written: all prefilled prompt tokens, plus one token
        # per decode step (the final sampled token's KV is never written)
        written = run.seq_len if run.prefill_done else run.prefilled
        tokens = run.request.prompt + run.generated
        n_full = min(written // ps, len(run.pages))
        parent = None
        for i in range(n_full):
            page = run.pages[i]
            if page in self._page_hash:          # shared hit: already indexed
                parent = self._page_hash[page]
                continue
            blk = tuple(tokens[i * ps: (i + 1) * ps])
            h = hash((parent, blk))
            if h not in self._prefix_index:      # first writer wins
                self._prefix_index[h] = (page, parent, blk)
                self._page_hash[page] = h
                self._prefix_children.setdefault(parent, {})[page] = blk
            parent = h
        # sub-page sharing: the partial tail page is registered too (its
        # blk is shorter than a page, so it is never a full-chain hit; it is
        # found by _partial_lookup's content scan and served through the
        # partial-page copy)
        tail = written - n_full * ps
        if tail > 0 and n_full < len(run.pages):
            page = run.pages[n_full]
            if page not in self._page_hash:
                blk = tuple(tokens[n_full * ps: written])
                h = hash((parent, blk))
                if h not in self._prefix_index:
                    self._prefix_index[h] = (page, parent, blk)
                    self._page_hash[page] = h
                    self._prefix_children.setdefault(parent, {})[page] = blk

    def check_page_invariants(self) -> None:
        """Page-pool conservation (a test aid): every page but scratch 0 is
        exactly one of free / cached-free / live, live refcounts match the
        number of referencing runs, pages shared across runs are registered
        prefix pages, and block tables only point at owned pages.  Raises
        AssertionError on violation."""
        refs: Dict[int, int] = {}
        for s in self._slots:
            if s is None:
                continue
            for p in s.pages:
                refs[p] = refs.get(p, 0) + 1
            row = self._block_tables[s.slot]
            assert set(row[row != 0]).issubset(set(s.pages))
        free, cached, live = (set(self._free_pages), set(self._cached_free),
                              set(refs))
        assert len(free) == len(self._free_pages), "free-list duplicate"
        assert not (free & cached) and not (free & live) and not (cached & live)
        assert free | cached | live == set(range(1, self.num_pages))
        if self.prefix_cache:
            assert refs == self._page_refs, (refs, self._page_refs)
        for p, n in refs.items():
            if n > 1:
                assert p in self._page_hash, f"unregistered page {p} shared"
        if self._held is not None:
            # only pages with content are held, and every live run's group
            # holds each of its pages
            assert set(self._held) <= cached | live, "a free page is held"
            assert all(self._held[p] for p in cached)
            for s in self._slots:
                if s is not None:
                    g = self._owner(s.slot)
                    assert all(self._held[p] >> g & 1 for p in s.pages), \
                        f"slot {s.slot} reads pages its group {g} lacks"
