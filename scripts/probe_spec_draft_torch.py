"""Tokens per forward of draft-model speculative serving with a drafter
equal to the target, and where the drafter's page pool parts from the
target's.

    python3 scripts/probe_spec_draft_torch.py ROOT [VARIANTS] [OUT.json]

ROOT is a checkout of the repository (this one, or an older commit's
``git archive``); its package and its ``chip_smoke.run_serving_spec`` run
the ``[serve spec draft step_batch]`` traffic: Qwen2.5-7B at full depth
(28 layers) from ``chip_smoke.py``'s seeded weights, W4A8 gs 256, a bf16
page pool of 8 slots and pages of 512, spec_k 4, greedy, 8 echo prompts
(150..1350 tokens, 32 new each) drawn from numpy seeds 0 and 1.  VARIANTS
(comma-separated, default ``kernels``):

* ``kernels``: the tree as it is;
* ``plain``: the paged decode and verify replaced by their plain versions
  (an fp32 softmax, P rounded to bf16 once: the reference arithmetic),
  launch counters kept;
* ``refeed``: the kernels, with the drafter protocol before this probe
  (``refeed_inputs`` / ``refeed_round`` below): each round's step 0
  feeds the token before the last again and rewrites its KV, and the
  round's last draft is never fed.

A drafter whose decode computed what the target's verify computes would
accept every draft.  ``run_serving_spec`` fails a run of at most 5 - 1 = 4
tokens a forward; that verdict is recorded, not raised.  Then, for each
variant, the seed-0 traffic again through ``step``: after every step,
each decoding row's positions before its last in the two pools (every
layer, K and V) are compared, and the first position where they differ
is recorded, counted from the row's prompt length.  Prints one JSON
object (and writes it to OUT.json when given), with the card's name and
power limit.  Needs a CUDA device.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys


def refeed_inputs(self, decoding):
    """``_model_inputs`` that also keeps each row's token before the last
    (``h[seq_len - 1]``) on the engine for ``refeed_round``."""
    import numpy as np

    prev = np.zeros((self.max_slots,), np.int64)
    for s in decoding:
        prev[s.slot] = (s.request.prompt + s.generated)[s.seq_len - 1]
    self._refeed_prev = self._tensor(prev)
    return BUILT["inputs"](self, decoding)


def refeed_round(self, tok_last, pos0, tables, active, sp_rows):
    """A draft-model round as the drafter ran before: step 0 feeds the
    token before the last at pos0 - 1 (rewriting its KV), steps 1..k the
    last token and drafts 1..k-1; draft k is never fed."""
    import torch

    from qwen_inference_engine_tpu_torch.engine.spec_engine import (
        decode_step,
    )

    k, tok_prev = self.spec_k, self._refeed_prev
    cur, ys = tok_last, []
    for i in range(k + 1):
        tok_in = tok_prev if i == 0 else (tok_last if i == 1 else cur)
        logits, self.draft_cache = decode_step(
            self.draft_params, self.draft_cfg, tok_in, pos0 - 1 + i,
            self.draft_cache, tables)
        cur = torch.argmax(logits, dim=-1)
        ys.append(cur)
    drafts = torch.stack(ys[1:], dim=1)
    tokens = torch.cat([tok_last[:, None], drafts], dim=1)
    chain, n_new = self._verify(tokens, pos0, tables, drafts, active,
                                sp_rows)
    rows = torch.arange(chain.shape[0], device=self.device)
    self._refeed_prev = torch.where(
        n_new >= 2, chain[rows, (n_new - 2).clamp(min=0)], tok_last)
    return chain, n_new, chain[rows, n_new - 1], pos0 + n_new


BUILT = {}


def first_parting(torch, cs, cfg, params, rng, steps=40):
    """The seed traffic through ``step``; after each step the first
    position (from the prompt's end) where a decoding row's drafter pool
    and target pool differ, per row (its first parting only)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, max_slots=8, page_size=cs.PAGE, num_pages=48,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
        sampling=SamplingParams(greedy=True), kv_dtype=torch.bfloat16,
        speculative=True, spec_k=cs.SPEC_K, spec_ngram=3, device="cuda",
        draft_params=params, draft_cfg=cfg)
    cb._eos = set()
    prompts = cs.echo_prompts(rng, cfg.vocab_size,
                              [100, 200, 300, 400, 500, 600, 700, 900])
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p,
                          max_new_tokens=cs.NEW_TOKENS))
    parted, compared, step = {}, 0, 0
    while cb.has_work() and step < steps:
        cb.step()
        step += 1
        for s in cb._slots:
            if s is None or not s.prefill_done or not s.generated \
                    or s.request.request_id in parted:
                continue
            n = s.seq_len - 1
            j = torch.arange(n, device="cuda")
            table = torch.as_tensor(cb._block_tables[s.slot],
                                    device="cuda").long()
            pages, off = table[j // cs.PAGE], j % cs.PAGE
            diff = torch.zeros(n, dtype=torch.bool, device="cuda")
            for a, b in ((cb.cache.k_pages, cb.draft_cache.k_pages),
                         (cb.cache.v_pages, cb.draft_cache.v_pages)):
                # [n, L, Hk, D]: the indexed dimension comes first
                diff |= (a[:, pages, :, off] != b[:, pages, :, off]).flatten(
                    1).any(1)
            compared += 1
            if bool(diff.any()):
                p = int(diff.nonzero()[0])
                parted[s.request.request_id] = dict(
                    step=step, position=p,
                    from_prompt_end=p - len(s.request.prompt),
                    positions_apart=int(diff.sum()), of=n)
    del cb
    torch.cuda.empty_cache()
    return dict(steps=step, rows_compared=compared, parted=parted)


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    variants = (sys.argv[2] if len(sys.argv) > 2 else "kernels").split(",")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_spec_draft_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.engine import spec_engine
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )
    from qwen_inference_engine_tpu_torch.utils.metrics import kernel_wrappers

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["qwen2.5-7b"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(bf16, QuantConfig(bits=4, group_size=256))
    del bf16
    cfg8 = cfg.replace(act_bits=8)
    wrappers = kernel_wrappers()
    names = ("paged_decode_attention_stacked",
             "paged_verify_attention_stacked")
    built = {n: getattr(qwen, n) for n in names}
    mixin = spec_engine.SpeculationMixin
    BUILT.update(round=mixin._model_round, inputs=mixin._model_inputs)

    def plain(name):
        wrapper = built[name]

        def call(*args):
            wrapper.launches += 1
            return pa.paged_decode_attention_plain(*args)

        return call

    out = {"root": root, "card": card, "runs": {}, "pools": {}}
    for variant in variants:
        for n in names:
            setattr(qwen, n, plain(n) if variant == "plain" else built[n])
        refeed = variant == "refeed"
        mixin._model_round = refeed_round if refeed else BUILT["round"]
        mixin._model_inputs = refeed_inputs if refeed else BUILT["inputs"]
        for seed in (0, 1):
            text = io.StringIO()
            try:
                with contextlib.redirect_stdout(text):
                    cs.run_serving_spec(
                        torch, cfg8, params, wrappers,
                        np.random.default_rng(seed), torch.bfloat16,
                        "step_batch", draft=True)
                verdict = "passed"
            except SystemExit as exc:   # the run's own check, reported
                verdict = str(exc)
            print(text.getvalue(), end="", flush=True)
            tpf = re.search(r"tokens per forward ([0-9.]+)", text.getvalue())
            out["runs"][f"{variant} seed {seed}"] = dict(
                tokens_per_forward=float(tpf.group(1)) if tpf else None,
                verdict=verdict)
        out["pools"][variant] = first_parting(
            torch, cs, cfg8, params, np.random.default_rng(0))
        print(f"pools {variant}: {out['pools'][variant]}", flush=True)
    for n in names:
        setattr(qwen, n, built[n])
    mixin._model_round = BUILT["round"]
    mixin._model_inputs = BUILT["inputs"]
    print(json.dumps(out))
    if len(sys.argv) > 3:
        with open(sys.argv[3], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
