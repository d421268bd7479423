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
is recorded, counted from the row's prompt length, with the positions
apart and, at the first, the first layers whose K or V differ and by how
much (a difference from layer 0 on means the two pools hold another
token or position there, not another rounding); and, where that step's
round wrote the position, the drafter's decode step and the verify's
column for it compared op by op (``rms_norm``, ``apply_linear``,
``apply_rope`` and the paged attention, each call's output): the first
ops whose outputs differ, with their layers, and where the first is a
norm, its input row in both and that row normalized inside either batch
shape.  Last, how often random rows normalized inside [8, 5, H] and
inside [8, 1, H] tensors differ, for the port's norm (an f32 mean) and
for one whose variance is summed in f64.  Prints one JSON
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


def step_module():
    """The module whose ``decode_step`` the tree's draft-model round calls
    for the drafter: ``parallel/tp_step`` (its makers) where the tree has
    it, else ``engine/spec_engine``."""
    try:
        from qwen_inference_engine_tpu_torch.parallel import tp_step
        return tp_step
    except ImportError:
        from qwen_inference_engine_tpu_torch.engine import spec_engine
        return spec_engine


def refeed_round(self, tok_last, pos0, tables, active, sp_rows):
    """A draft-model round as the drafter ran before: step 0 feeds the
    token before the last at pos0 - 1 (rewriting its KV), steps 1..k the
    last token and drafts 1..k-1; draft k is never fed."""
    import torch

    k, tok_prev = self.spec_k, self._refeed_prev
    cur, ys = tok_last, []
    for i in range(k + 1):
        tok_in = tok_prev if i == 0 else (tok_last if i == 1 else cur)
        logits, self.draft_cache = step_module().decode_step(
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


def rms_norm_f64(x, weight, eps):
    """``ops.norms.rms_norm`` with the variance summed in f64, then
    rounded to f32 (a candidate batch-invariant norm; not the port's)."""
    import torch

    xf = x.float()
    var = xf.double().square().mean(dim=-1, keepdim=True).float()
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def norm_sweep(torch, norm, H, B=8, T=5, trials=200, scale=4.0):
    """How often a row of random bf16 x [B, T, H] (x ``scale``) normalized
    inside the [B, T, H] tensor differs from the same row normalized
    inside a [B, 1, H] one: (rows apart, rows compared) for ``norm``."""
    g = torch.Generator(device="cuda").manual_seed(5)
    w = (1 + 0.1 * torch.randn((H,), generator=g, device="cuda")).to(
        torch.bfloat16)
    apart = 0
    for _ in range(trials):
        x = (scale * torch.randn((B, T, H), generator=g, device="cuda")).to(
            torch.bfloat16)
        many = norm(x, w, 1e-6)
        for t in range(T):
            one = norm(x[:, t:t + 1].contiguous(), w, 1e-6)[:, 0]
            apart += int((one != many[:, t]).any(-1).sum())
    return apart, trials * B * T


OPS = ("rms_norm", "apply_linear", "apply_rope", "_paged_attention")


class OpRecorder:
    """While a step runs, every call of ``OPS`` in ``models.qwen`` records
    its output under the forward it belongs to: ("draft", i) for the
    round's i-th drafter decode step, ("verify",) for the target's verify
    with its logits (other forwards, such as prefill pieces, are not
    recorded).  The drafter's steps are ``step_module().decode_step``; the
    verify is ``parallel/tp_step``'s verify maker's ``forward_hidden(...,
    ragged_multi=True)`` and the ``compute_logits`` after it, or
    ``SpeculationMixin._verify`` in a tree without the makers."""

    def __init__(self, torch, qwen, spec_engine):
        self.torch, self.qwen, self.spec = torch, qwen, spec_engine
        self.phase, self.records, self.drafts = None, {}, 0
        self.saved = {n: getattr(qwen, n) for n in OPS}
        self.mod = step_module()
        self.makers = self.mod is not spec_engine
        self.saved_step = self.mod.decode_step
        self.saved_verify = (self.mod.forward_hidden if self.makers
                             else spec_engine.SpeculationMixin._verify)
        self.saved_logits = getattr(self.mod, "compute_logits", None)

    def __enter__(self):
        rec = self

        def wrap(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                if rec.phase is not None:
                    # a norm also keeps its input, weight and eps
                    args_kept = ((args[0].detach().clone(), *args[1:])
                                 if name == "rms_norm" else None)
                    rec.records.setdefault(rec.phase, []).append(
                        (name, out.detach().clone(), args_kept))
                return out
            return call

        def draft_step(*args, **kw):
            rec.phase = ("draft", rec.drafts)
            rec.drafts += 1
            try:
                return self.saved_step(*args, **kw)
            finally:
                rec.phase = None

        def verify(*args, **kw):
            if self.makers and not kw.get("ragged_multi"):
                return rec.saved_verify(*args, **kw)   # a prefill piece
            rec.phase = ("verify",)
            try:
                return rec.saved_verify(*args, **kw)
            finally:
                if not self.makers:
                    rec.phase = None

        def logits(*args, **kw):
            # the maker's verify ends with its logits
            try:
                return rec.saved_logits(*args, **kw)
            finally:
                rec.phase = None

        for n in OPS:
            setattr(self.qwen, n, wrap(n, self.saved[n]))
        self.mod.decode_step = draft_step
        self._set_verify(verify, logits)
        return self

    def _set_verify(self, fn, logits=None):
        if self.makers:
            self.mod.forward_hidden = fn
            self.mod.compute_logits = logits
        else:
            self.spec.SpeculationMixin._verify = fn

    def __exit__(self, *exc):
        for n in OPS:
            setattr(self.qwen, n, self.saved[n])
        self.mod.decode_step = self.saved_step
        self._set_verify(self.saved_verify, self.saved_logits)

    def clear(self):
        self.records, self.drafts = {}, 0

    def compare(self, slot, i, T):
        """The round's drafter step i against column i of the verify, op by
        op for row ``slot``: the first ops (in call order, with their
        layer) whose outputs differ, and how many do; where the first is a
        norm, whether its input row was the same and what the norm gives
        that row inside each batch shape (``norm_replay``)."""
        draft = self.records.get(("draft", i), [])
        verify = self.records.get(("verify",), [])
        apart, norms, replay = [], 0, None
        for n, ((name, a, args), (name_v, b, args_v)) in enumerate(
                zip(draft, verify)):
            if name != name_v:
                return dict(error=f"op {n}: {name} against {name_v}")
            norms += name == "rms_norm"    # two a layer, then the final one
            layer = max(norms - 1, 0) // 2
            x = a[slot, 0] if a.dim() > 1 and a.shape[1] == 1 else a[slot]
            y = b[slot, i] if b.dim() > 1 and b.shape[1] == T \
                else b[slot * T + i]
            d = float((x.float() - y.float()).abs().max())
            if d != 0 or bool(x.isnan().any() != y.isnan().any()):
                apart.append((n, name, layer, d))
                if len(apart) == 1 and name == "rms_norm":
                    replay = self.norm_replay(args, args_v, slot, i)
        return dict(ops=len(draft), verify_ops=len(verify),
                    ops_apart=len(apart), first_apart=apart[:8],
                    norm_replay=replay)

    def norm_replay(self, args, args_v, slot, i):
        """The first parting norm's input row in both forwards, and that
        row normalized inside the drafter's [B, 1, H] tensor and inside
        the verify's [B, T, H] one (the verify's own input with the row
        put in), by the port's norm (an f32 mean) and with the variance
        summed in f64."""
        torch = self.torch
        x, w, eps = args
        xv = args_v[0]
        row_same = bool(torch.equal(x[slot, 0], xv[slot, i]))
        wide = xv.clone()
        wide[slot, i] = x[slot, 0]
        out = {"input_row_equal": row_same}
        for kind, norm in (("f32 mean", self.saved["rms_norm"]),
                           ("f64 mean", rms_norm_f64)):
            one = norm(x, w, eps)[slot, 0]
            many = norm(wide, w, eps)[slot, i]
            out[kind] = dict(
                bit_equal=bool(torch.equal(one, many)),
                elements_apart=int((one != many).sum()))
        return out


def first_parting(torch, cs, cfg, params, rng, steps=40, recorder=None):
    """The seed traffic through ``step``; after each step the first
    position (from the prompt's end) where a decoding row's drafter pool
    and target pool differ, per row (its first parting only).  With a
    ``recorder`` (an entered OpRecorder), each parting also gets the op
    by op comparison of the drafter step and the verify column that wrote
    its first position in that step's round."""
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
        # each row's round starts at its length before the step, or at its
        # prompt's end where the step finishes its prefill
        seq0 = {x.request.request_id: x.seq_len for x in cb._slots
                if x is not None and x.prefill_done}
        if recorder is not None:
            recorder.clear()
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
                pg, o = int(table[p // cs.PAGE]), p % cs.PAGE
                layers = {}
                for kind, a, b in (
                        ("k", cb.cache.k_pages, cb.draft_cache.k_pages),
                        ("v", cb.cache.v_pages, cb.draft_cache.v_pages)):
                    d = (a[:, pg, :, o].float() - b[:, pg, :, o].float()
                         ).abs().flatten(1).amax(1)
                    layers[kind] = [(i, float(x)) for i, x in
                                    enumerate(d.tolist()) if x != 0][:4]
                parted[s.request.request_id] = dict(
                    step=step, position=p,
                    from_prompt_end=p - len(s.request.prompt),
                    positions_apart=int(diff.sum()), of=n,
                    apart=diff.nonzero()[:, 0].tolist()[:12],
                    prompt_len=len(s.request.prompt), slot=s.slot,
                    generated=len(s.generated),
                    first_layers_apart=layers)
                pos0 = seq0.get(s.request.request_id,
                                len(s.request.prompt))
                if recorder is not None:
                    i = p - pos0
                    parted[s.request.request_id]["round_pos0"] = pos0
                    parted[s.request.request_id]["ops"] = (
                        recorder.compare(s.slot, i, cs.SPEC_K + 1)
                        if 0 <= i <= cs.SPEC_K else
                        "written before this step's round")
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
        with OpRecorder(torch, qwen, spec_engine) as rec:
            out["pools"][variant] = first_parting(
                torch, cs, cfg8, params, np.random.default_rng(0),
                recorder=rec)
        print(f"pools {variant}: {out['pools'][variant]}", flush=True)
    from qwen_inference_engine_tpu_torch.ops.norms import rms_norm

    out["norm_sweep"] = {
        kind: norm_sweep(torch, fn, cfg.hidden_size)
        for kind, fn in (("f32 mean", rms_norm), ("f64 mean", rms_norm_f64))}
    print(f"norm sweep (rows apart, rows): {out['norm_sweep']}", flush=True)
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
