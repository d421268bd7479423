#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [records.json]

With a path, the numbers of every kernel shape and run are also written
there as JSON.  Phases, in order; any failure exits non-zero and prints no result:

1. device: the card's name and power limit, TF32 off for the plain versions;
2. build: the CUDA kernels of ``qwen_inference_engine_tpu_torch/csrc`` with
   nvcc for sm_90a, one process per source;
3. each kernel against its plain PyTorch version on the card at the shapes
   Qwen2.5-7B gives it, with error, kernel / plain / library time and the
   bound (the larger of bytes at 3.35 TB/s and operations at the peak rate
   of their type: 989 TFLOP/s bf16, 1979 TOP/s int8): the four quantized
   matmuls at the seven projections and the offline-fused qkv (N = Qd +
   2 Kd) and gateup (N = 2 F) of ``fuse_projections``, each printing at
   M <= 64 whether its split-K plan equals the split projections' (M = 4,
   256, 2048, and M = 40 for the
   three split-K tensor-core kernels W4A8, W8A16 and W8A8, each printing
   its (mt, splits, slice) plan and timing M <= 64 also in a CUDA graph
   beside torch.matmul; W4A16 and W8A16 also the lm_head at M = 4; INT8
   per group of 128 rows and per column) and the 14B projections at M = 4;
   the contiguous decode attention (B = 4, lengths 69..1000 of S 1024) and
   the appending one (split S on the tensor cores, the fresh row staged
   from the inputs; B = 4 at position 999 of S 1024 and the batch-192
   default dispatch's B = 192 at position 272 of S 512, one split), each
   printing a CUDA graph's time beside SDPA's, the appending one its split
   plan, two calls bit-identical, and the fresh decode at B = 4, old
   lengths 999, bit-equal to it; the INT8-KV decode attention (split S on
   the tensor cores; B = 4 at
   lengths 69..2000 of S 2304 and at run (c)'s 37..500 of S 1024, each
   printing its split plan and a CUDA graph's time);
   the paged kernels over a 40-page pool of 512-token pages with shuffled
   tables and NaN in every page no table holds (the paged attentions'
   library yardstick is SDPA over a gathered copy, the gather timed beside
   it; the appends' an ``index_put_`` scatter), the paged chunks on the
   tensor cores (the serving piece with the 7B's and 30B-A3B's heads, a
   call and in a CUDA graph, each in-table start bit-equal to the
   contiguous chunk kernel through its own and identity tables); the contiguous chunk kernels (tensor cores, GQA-packed rows)
   at starts 512, 1024 and 1536, each kept in the kernels line as
   ``start_<start>``, and with per-row starts on the device (T = 5 and 16,
   NaN past each row's window, ``rows_T5`` / ``rows_T16``), each with its
   SDPA time and bound; the verify at T = 17
   and the window append at T = 9 over pages of 8 (windows wider than 16
   rows and than a page); the three grouped MoE matmuls at the
   Qwen3-30B-A3B expert shapes (gate/up K 2048 N 768, down K 768 N 2048;
   INT4 gs 256 / 128, INT8 per group of 128 and per column), layer 1 of a
   stacked [2, 128, ...] tensor, M = 256 (decode, batch 32 x top-8) and
   4096 (a 512-token piece) by random top-8 routing, and the edge sizes
   (empty experts, one expert taking every row, every tile straddling);
   their library yardstick is bf16 ``torch._grouped_mm`` over the
   dequantized slab where this torch has it (else a per-expert matmul
   loop, so labelled); the double-pumped decode's kernels: ``fused_mlp``
   at the 7B MLP (K 3584, F 18944; gs 256 / 128 at M = 4, 8, 40, 192 and
   256, gs 128 / 128 at M = 4; yardstick bf16 ``torch.matmul`` x 3 +
   SiLU over the dequantized weights), ``fused_attn_mlp`` at a half batch
   of 96 rows (row0 0 and 96 of 192, lengths 257, S 512; yardstick SDPA
   over the half's rows + the bf16 MLP) beside Mb = 96 MLP rows, and
   from row 96 beside Mb = 40 (each printing both MLP plans and a CUDA
   graph's time) and ``kv_append_uniform`` (96 rows
   from row 96, bit-exact; yardstick a slice assignment; both also in a
   CUDA graph), each also called
   twice for bit-identical results; the last four sites' kernels:
   ``kv_append_ragged_t`` (Hk 4, D 128, 4 rows of S 1024, T = 1 and 5,
   bf16 and int8 with its scales, starts -1, 7, 8, 31, 32, S - T, 0 and a
   window crossing S; bit-exact, yardstick an ``index_put_`` scatter;
   each shape with its row kernel plan, it and its yardstick also in a
   CUDA graph),
   ``decode_attention_contiguous_fresh`` (B = 4 at S 1024, B = 192 at S
   512, old lengths 0 .. S - 1, 1e4 at and past each, each with its split
   plan and a CUDA graph's time; yardstick SDPA over the cache with the
   fresh row written first), ``kv_append_all_uniform``
   (28 layers, B = 4 and 192; bit-exact; it and its yardstick also in a
   CUDA graph) and ``fused_attn_matmul`` at
   ``scripts/probe_fused.py``'s shapes (56 rows of a 112-row cache, S
   1024, lens S - 7, the 7B gate projection K 3584 N 18944 INT4 gs 256,
   row0 0 and 56; its plan; y bit-equal to ``quant_matmul4``'s, the
   attention to ``fused_attn_mlp``'s; yardstick SDPA + bf16
   ``torch.matmul``; both also in a CUDA graph); and, not timed, every
   kernel of the TP paths at the shapes Qwen2.5-7B's shards give a rank
   at tp = 2 and 4 (``check_tp_shards``: the four dense matmuls with groups
   of 64 over the unpadded shard K, the lm_head's vocabulary shard, flash
   attention, the ragged decode and window append, the paged decode,
   chunk and appends at 2 and 1 KV heads), each held to its tolerance
   here; and the three grouped kernels at the shard shapes the EP layer
   gives a rank (``check_ep_grouped``, ``[ep shards]``: e_loc = 64 / 32
   experts at ep 2 / 4 over the P x M-row receive buffer of 16 and 2048
   tokens a rank, gate / up and down; the output prefilled with NaN,
   which must stay in every row past the last group; timed beside the
   plain version and ``torch._grouped_mm`` over the covered rows); and
   the four row0 variants at the pipeline's 1F1B row windows
   (``check_row0_kernels``: ``decode_attention_appending``, ``_contiguous``,
   ``_contiguous_q8`` and ``kv_append_uniform_q8`` at Qwen2.5-7B's heads, b
   = 8 / S rows of a cache of 8 at pp = S = 2 and 4, S 256, position 136,
   every row0 = m b bit-equal to the same call at row0 0 on a copy of the
   window's rows, the other rows untouched, within 2e-2 of the plain
   version (the append bit for bit); a call and a CUDA graph's time beside
   the plain version and SDPA / a slice assignment, the rows' bytes as the
   bound; kept in the kernels line as ``at_row0`` with the zero-copy
   [pp 1f1b] launches of each rank);
4. end to end: Qwen2.5-7B at full width and depth (28 layers), random
   weights from a seeded generator, W4A8 gs 256, through
   ``Engine.generate``, 32 new tokens each: in bf16 KV a ragged batch
   (prompts of 37, 120, 300 and 500 tokens) and an aligned batch (4 x 256)
   at max_seq 1024; then prompts longer than one 512-token chunk (bucket
   2048, three continuation chunks) at max_seq 2304: bf16 KV aligned
   (4 x 1408) and ragged (700, 1100, 1408, 1900), INT8 KV aligned
   (4 x 1408) and ragged (37, 600, 1408, 1900).  Then the other weight
   formats, quantized from the same bf16 params: (a) W4A16 gs 128 with an
   INT4 lm_head, ragged; (b) W8A16 gs 128, aligned 4 x 256; (c) W8A8 one
   scale per column, INT8 KV, ragged; (d) the JAX bench's headline weights
   (W4A8 gs 256 and an INT4 lm_head at act_bits_lm_head=0), ragged; each
   must launch only its own matmul kernels, 7 per layer per forward (+1
   for a quantized lm_head), but (a) runs its decode steps' MLP (M = 4,
   pad-free at gs 128) as ``fused_mlp``: 4 matmuls and one fused MLP a
   layer.  Every ragged run writes each decode step's K/V with
   ``kv_append_ragged_t`` (once a layer a step), every aligned one never.
   Every launch count is set to 0 just before
   each run and read just after, and each run must have launched the
   kernels of its path and none of the others';
   [fused generate]: ``fuse_projections`` of the W4A8 params and of (a),
   the ragged batch through ``Engine.generate`` beside the split params:
   4 matmuls a layer a forward (+ the INT4 lm_head), no ``fused_mlp``,
   prefill logits bit-equal to the split params' (one K slice at M =
   2048), where the greedy tokens part, and the captured decode step
   against its eager steps with host / device ms beside the split case;
   [fused serve]: the fused W4A8 params through ``ContinuousBatchingEngine``
   (8 slots, pages of 512, pieces of 256) on 8 requests of 37..1408
   tokens beside the split run: 4 matmuls a layer for every tick and
   piece, [serve]'s rule, where the tokens part; [ppl]: the perplexity of
   tests/test_ppl.py's stream formula at 2048 tokens (windows of 512,
   batch 4) for bf16, W8A16 gs 128, W4A16 gs 128, W4A8 gs 256, W4A8 fused
   and W4A8 at batch 1, with its gates (W8A16 within 0.02 of bf16, INT4
   within 0.10, fused and batch 1 within 1e-3 of W4A8), ms and launches
   a batch of windows;
4b. serving: ``ContinuousBatchingEngine`` on the same full-depth model at
   the JAX defaults (8 slots, pages of 512, pieces of 256, prefix cache on,
   8 decode ticks per sync), EOS off: 12 greedy requests (prompts of 37 to
   1408 tokens) onto 8 slots, then 4 that share an 1100-token prefix with a
   finished one, 32 new tokens each.  Every request must finish by length;
   the four paged kernels, flash and the W4A8 matmul must launch (one paged
   decode and append per layer per decode tick, one prefill append per
   layer per piece), no contiguous-cache kernel may, the prefix cache must
   hit and a mixed prefill + decode window must run; after the counts are
   read, a 2040-token prompt is sent twice (the second's last piece runs
   past its 4-page table) and both must finish, then 8 more requests fill
   the slots and one window of 8 decode ticks is timed, and the next one
   profiled (device busy time, kernels by device time); then the HTTP
   ``Server`` on 127.0.0.1 answers /generate, a streamed /v1/completions,
   /v1/chat/completions and /stats; then 8 requests (37 to 1100 tokens, 16
   new each) on the W4A16 params, which must launch the INT4 x bf16 matmul,
   ``fused_mlp`` (every forward has M <= 256) and the paged kernels and
   never the W4A8 one;
4c. the INT8 page pool and speculation, on the same W4A8 model: the
   serving run of 4b over an INT8 pool (only the q8 paged attentions may
   launch); prompt-lookup speculation (spec_k 4, ngram 3) on 8 echo
   prompts (a passage and its first half again, 150..1350 tokens) through
   ``step`` and ``step_batch`` over a bf16 and an INT8 pool, and a drafter
   equal to the target (more than 4 tokens per forward required), after
   the same traffic by plain chained decode (the yardstick); each
   speculative run must launch the verify kernel and the windowed append;
   then
   ``Engine.generate_speculative`` against ``Engine.generate`` at batch 4
   (the verify's logits within 1.5x the measured distance of ``generate``
   from ``generate`` with the plain attention versions, tokens equal up to
   the first near-tie; each verify forward writes its windows with
   ``kv_append_ragged_t`` once a layer), and one ``qie serve --speculative
   --kv-bits 8``
   request over HTTP with /stats;
4d. the double-pumped decode ([pumped generate]): the JAX bench's pumped
   weights (W4A16 gs 256 pad-free, so down gs 128, and an INT4 lm_head)
   through ``Engine(..., pumped=True).generate`` on an aligned batch of
   192 x 256-token prompts (max_seq 512, bf16 KV, 32 new tokens): each
   decode step must launch ``fused_attn_mlp`` and ``kv_append_uniform``
   2 x 28 times and the W4A16 matmul 8 x 28 + 3 + 1 times, and no decode
   attention or ``fused_mlp``; the same batch through the default
   dispatch (no pump: ``fused_mlp`` and the appending attention 28 times a
   step, the W4A16 matmul 4 x 28 + 1), its tok/s beside the pumped one;
   then from one prefill of the batch, 8 pumped steps and 8
   plain ``decode_step(uniform_decode=True)`` steps (the yardstick;
   ``fused_mlp`` 28 times a step at M = 192) by the host clock, each with 4
   more under the profiler (device busy share, kernels by device time),
   and [deferred decode]: 8 (+4) deferred-append steps
   (``decode_step(..., deferred_append=True)``: 28 fresh-merge attentions
   and one all-layer append a step, no appending attention; an ablation
   no entry point dispatches);
4e. [probe fused], the port of ``scripts/probe_fused.py``: at its shapes,
   the decode attention alone on a 56-row cache (t_attn), the W4A16 gate
   projection alone (t_mm) and one ``fused_attn_matmul`` doing both
   (t_fused), between full overlap (the max) and none (the sum), a call
   and in a CUDA graph;
loader: a checkpoint in HF layout (config, index, two BF16 shards, q/k/v
   biases, an untied lm_head) at the Qwen2.5-7B widths and 2 layers, taken
   from the seeded params and written into a temporary directory (deleted
   afterwards) without the safetensors package; ``load_checkpoint`` on the
   card must give every tensor bit for bit; ``quantize --bits 4`` then
   ``load_quantized`` must give ``quantize_params`` of the loaded params bit
   for bit; ``generate --qckpt`` and ``generate --ckpt --bits 4`` must give
   the same greedy ids, and ``generate --ckpt`` runs at every weight format
   and with ``--speculative``; ``serve --ckpt --bits 4 --kv-bits 8
   --speculative`` answers a request through HTTP and stops; [cli utils]:
   ``generate --chat --stats --profile DIR`` (the stats JSON, the chat
   template's prompt tokens, a trace in DIR with ``qmm_mma_kernel`` and
   ``flash_kernel``), and a debug hook in a captured step body (printing
   eagerly, raising under capture);
5. the kernel path against the plain path on the card, the same weights at
   a depth of 4 layers: in bf16 KV, prefill logits (one chunk) and 8 greedy
   tokens, for W4A8, W4A16 (INT4 lm_head) and W8A8; in INT8 KV, the logits
   of a chunked prefill of prompts of 600 to 1000 tokens (a fresh chunk and
   a continuation).  Each path is held against an fp32 run of the plain
   path (over an int8 cache in the INT8 case), and the kernel path may be
   at most 1.5x as far from it as the plain bf16 path is (with random
   weights, bf16 rounding alone moves the logits by a few tenths); the same
   over the page pool, bf16 and INT8: a paged prefill of three pieces
   across two pages, 4 paged decode steps, then a verify of 5 tokens; and
   the pumped weights at 4 layers, batch 192 x 64: 2 steps of
   ``decode_step_pumped``, 2 of ``decode_step`` (``fused_mlp`` at
   M = 192) and 2 deferred-append steps, each held to 1.5x its plain bf16
   path's distance from an fp32 run of the plain ``decode_step``; the
   deferred step's cache after one step equals ``decode_step``'s bit for
   bit; the fused parameters of W4A8, W4A16 and W8A8 (4 matmuls a layer)
   on the same rule against the split parameters' plain and fp32 runs,
   and ``score_logits`` (all [4, 512, V] scores, W4A8) on it too.

6. Qwen3-MoE: ``qwen3-30b-a3b`` at full width (128 experts, top-8, Fm
   768), random packed weights drawn on the card: W4A8 gs 256 at the full
   48 layers through ``Engine.generate`` (batch 32 x 512-token prompts, 32
   new tokens, INT8 KV: the JAX bench's MoE row), which must launch the
   W4A8 grouped kernel 3 x 48 times a forward; ``ContinuousBatchingEngine``
   on it over a bf16 and an INT8 pool (8 requests on 8 slots, 4 sharing a
   600-token prefix with a finished one) and with prompt lookup on echo
   traffic; phase 5's logits rule at 4 layers; then W4A16 gs 128 (24
   layers) and W8A16 gs 128 (12 layers), each launching its own grouped
   kernel; a 2-layer checkpoint of the preset's widths in HF layout
   through ``load_checkpoint``, ``quantize``, ``load_quantized`` and
   ``generate --ckpt`` / ``--qckpt``.  The dense runs above must launch no
   grouped kernel.

7. tensor and data parallelism (``parallel/``): Qwen2.5-7B W4A8 at the
   full 28 layers with INT4 groups of 64 (the tp = 4 shards' aligned
   size), the same seeded params in every process.  [tp graph]:
   ``make_tp_decode_fn`` over an NCCL group of one, its decode step
   captured (56 all-reduces inside the graph) and bit-equal to the eager
   step.  Then gloo worlds of 2 and 4 ranks sharing the card (NCCL refuses
   two ranks on one device; the gloo collectives are staged through the
   host, so these ranks take eager steps): [tp generate] at tp = 2 and 4
   (greedy ``Engine.generate``, batch 4, 16 tokens: every rank's tokens
   equal, the first decode step's logits, the ranks' vocabulary shards
   joined, within twice the single-rank W4A8 vs W4A16 distance of the
   single-rank run; each rank's launches at its shard shapes, the
   all-reduces 2 a layer and 1 (the embedding's) a forward), [dp generate] at dp = 2 (each data
   rank's rows on the same rule) and [tp serve] at tp = 2 (6 requests on
   4 slots over a bf16 pool, 2 sharing a 2-page prefix: every rank's
   tokens equal and by length, the paged kernels launched, every greedy
   token equal to the single-rank scheduler's).  The ranks time-share the
   card's SMs: nothing here measures TP speed.
7b. serving over a data axis and speculation under a mesh, in phase 7's
   two gloo worlds after their own runs, on the first ``DP_LAYERS`` = 4
   of the ranks' 28 layers (views; depth cut for time, printed).  [dp
   serve] at (dp, tp) = (2, 1) and (2, 2): ``ContinuousBatchingEngine``
   on 8 slots (4 a data group) over a bf16 pool of 512-token pages,
   prefix cache on: 8 requests of 37..1100 tokens, then two on data group
   0's slots sharing 1024 and 1040 tokens of slot 7's prompt, whose pages
   group 1 wrote (the cross-group page copy, ``broadcast_data``, runs:
   its launches and bytes printed), 16 new tokens each: every rank's
   tokens equal and by length, each request's greedy tokens equal to the
   single-rank scheduler's or parting at a near-tie (the single-rank
   run's own top-two logit margin at the first step that differs, which
   the reference records, below twice the single-rank W4A8 vs W4A16
   distance of a first decode step's logits: phase 7's rule at this
   depth; the parts printed; at (2, 2) o's and down's int8 activations
   take each token's scale over the whole row, as under the JAX
   scheduler's GSPMD); the prefix hits equal to the single rank's, the
   paged decode, chunk and appends, the logits gather and the page
   broadcast launched on every rank.  [mesh spec] at (2, 1) and
   (1, 2): ``Engine.generate_speculative`` (k 4, 4 echo prompts, 32 new,
   EOS off): every rank's ids equal, each row equal to the single-rank
   ``generate_speculative``'s and greedy ``Engine.generate``'s or parting
   at a near-tie (their own margins); flash,
   ``chunk_attention_contiguous`` and ``kv_append_ragged_t`` launched on
   every rank.  Nothing here measures DP speed
   (``scripts/time_dp_torch.py`` does, on four cards).
8. expert parallelism (``parallel/ep_*.py``), gloo ranks sharing the card
   (spawned), Qwen3-30B-A3B at full width, W4A8 gs 256, the same seeded
   params in every process.  [ep moe] at ep = 2 and 4: ``ep_moe_layer``
   of one layer on 16 and 2048 tokens a rank: the ragged and dense forms
   bit for bit, within 2^-6 of the largest output of ``moe_mlp`` on one
   rank over the whole batch, finite and bit-equal with every grouped
   output prefilled with NaN (the uncovered rows still NaN after each
   call), 3 grouped launches, 2 all-to-alls and 1 all-gather a layer.
   [ep serve] at ep = 2 (``ContinuousBatchingEngine``, 8 slots, pages of
   512, pieces of 256; depth cut to ``EP_LAYERS`` for time, printed): 8
   requests (two longer than two pieces, on both ranks' slots: the
   batched interior pieces run) over a bf16 pool, 8 echo requests by
   prompt lookup, the 8 again over an INT8 pool: every rank's tokens
   equal, each request's greedy tokens equal to the single-rank
   scheduler's or parting at a near-tie (the single-rank logit gap
   between the two candidates below the bound), a first decode tick's
   logits (the ranks' rows gathered) within twice the single-rank W4A8 vs
   W4A16 distance; per-rank launches.  Nothing here measures EP speed.
9. pipeline parallelism (``parallel/pp_step.py``,
   ``engine/pp_scheduler.py``), gloo ranks sharing the card (spawned), in
   worlds of 2 and 4 ranks at once (``spawn_worlds``, as phases 7-8 now
   run theirs): Qwen2.5-7B W4A8 with INT4 groups of 64, the same seeded
   params in every process, each stage keeping its layers.  [pp forward]
   at pp = 2 and 4, 28 layers: a prefill of 4 ragged prompts (37, 100,
   200, 256 tokens), then 4 per-tick decode steps, the tokens fed from the
   single-rank run: every rank's last-token logits bit-equal to the
   single-rank ``prefill`` / ``decode_step``; each rank's launches (L / S
   flash a prefill, L / S ``kv_append_ragged_t`` and decode attentions a
   step, S ring exchanges and one broadcast a forward).  [pp 1f1b], 28
   layers: an aligned wave of 8 rows (128-token prompts), 16 steps, bf16
   and INT8 caches: zero-copy (``cache_row0``) and sliced give the same
   tokens and caches bit for bit; the zero-copy run launches the row0
   kernels L / S times a tick a rank (``decode_attention_appending``; INT8:
   ``kv_append_uniform_q8`` and ``decode_attention_contiguous_q8``), on
   every tick but the stage's skipped warm-up; the greedy tokens equal the
   single-rank ``Engine.generate``'s or part at a near-tie (the phase-7
   bound).  [pp serve] (``PPFifoScheduler``, 8 rows a wave, depth cut to
   ``PP_SERVE_LAYERS`` = 8 of 28 for time, printed): an aligned greedy
   wave (1F1B), a wave of greedy and sampled rows (sampled 1F1B), a
   penalized wave (the seen mask through the ticks) and a ragged wave (per
   tick), over a bf16 and an INT8 cache: every rank's tokens equal, every
   request by length, each wave on its decode path, greedy and penalized
   rows equal to the single-rank ``ContinuousBatchingEngine``'s or parting
   at a near-tie, or, for the ragged wave, bit-equal to one rank running
   the stages' own kernels (a one-stage ``PPFifoScheduler``): the part is
   then that rank's rounding between the paged and the contiguous kernels,
   which W4A8's per-token activation quantization can amplify.  Nothing
   here measures pipeline speed.

Captured steps: every ``Engine.generate`` decode step and every serving
decode tick above replays a CUDA graph (``engine/step_graph.py``; each
engine's warm-up call runs a key's first step eagerly and captures its
second), and each wrapper's launch count takes a replay's launches, so
the launch checks hold as they did for eager steps.  Where a check
intercepts Python calls (phase 5's plain-swapped generate, [generate
spec]'s recorded logits) the run takes the eager steps
(``step_graph.eager_steps()``).  Two phases hold the captured steps to
the eager ones:

* [graph generate] (after phase 4's formats, after [pumped generate] and
  in phase 6): one prefill (``Engine.start``), then the same 8 decode
  steps captured and eager from one copy of the decode buffers and the
  generator's state: logits, tokens and each step's launches bit for bit;
  then 8 of each by the host clock and 8 under the profiler (host ms,
  device busy ms, tok/s a step).  Cases: 7B W4A8 ragged batch 4 (bf16 and
  INT8 KV), aligned batch 4, (a) W4A16 (``fused_mlp``, 28 a step), a 2-layer
  sampled case (temperature 0.8, top-k 50, top-p 0.9, repetition penalty
  1.1, a seed), the pumped batch of 192 (56 ``fused_attn_mlp`` a step) and
  30B-A3B W4A8 at 48 layers, batch 32, INT8 KV;
* [graph serve] (after [serve int8]): two serving engines, 8 requests of
  300-token prompts on 8 slots, then windows of 8 ticks, one engine's
  captured and the other's eager (warm-up, host clock, profiler): every
  token equal, one graph for the captured engine; bf16 and INT8 pools at
  ``max_pages_per_seq`` 4, then the captured engine alone at 64 over the
  bf16 pool (every tick passes tables of the engine's full width, so a
  row's bits do not follow its neighbours: this prices that width).

Device busy time under the profiler counts the device's own rows
(kernels, copies, sets; ``device_rows``), not PyTorch ops' rows, which
repeat the time of the kernels they launched.

Then one JSON line of per-kernel numbers (30 wrappers over the JAX
package's 28 ``pallas_call`` sites, each launched; the four row0 variants
with their ``at_row0`` numbers), and as the last line
``{"ok": true, "device": {...}}``.  Every number is measured in this run.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_ST_DTYPES = {"bfloat16": "BF16", "float32": "F32", "float16": "F16",
              "int8": "I8", "int32": "I32", "int64": "I64"}


def write_hf_checkpoint(path: str, config: dict, tensors: dict,
                        shards: int = 2) -> None:
    """An HF checkpoint directory without the safetensors package:
    ``config.json``, ``model.safetensors.index.json`` and ``shards``
    safetensors files (8-byte little-endian header length, a JSON header
    padded to 8 bytes, then the raw bytes).  ``tensors`` maps HF names to
    torch tensors (any device)."""
    import struct

    import numpy as np
    import torch

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    names = list(tensors)
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    weight_map, runs, acc = {}, {}, 0
    for name in names:  # `shards` runs of about equal bytes, by midpoint
        n = tensors[name].numel() * tensors[name].element_size()
        runs.setdefault(min(shards - 1, int((acc + n / 2) * shards / total)),
                        []).append(name)
        acc += n
    groups = [runs[k] for k in sorted(runs)]
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        header, off = {}, 0
        for name in group:
            t = tensors[name]
            n = t.numel() * t.element_size()
            header[name] = {"dtype": _ST_DTYPES[str(t.dtype).split(".")[-1]],
                            "shape": list(t.shape),
                            "data_offsets": [off, off + n]}
            off += n
            weight_map[name] = fname
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for name in group:
                t = tensors[name].detach().contiguous().cpu()
                if t.dtype == torch.bfloat16:
                    t = t.view(torch.int16)
                np.ascontiguousarray(t.numpy()).tofile(f)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call with the host's launch cost out of the way:
    ``reps`` calls captured in a CUDA graph, replayed 5 times between CUDA
    events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (5 * reps)


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

# the four dense matmuls of the weight formats W4A8, W4A16, W8A16 and
# W8A8: weight bits, activation bits, tolerance (of the largest |output|),
# peak type; the (mt, splits, slice) planner of each split-K kernel
MATMULS = {"quant_matmul4_a8": (4, 8, 2 ** -6, "int8"),
           "quant_matmul4": (4, 0, 2 ** -6, "bf16"),
           "quant_matmul8": (8, 0, 2 ** -6, "bf16"),
           "quant_matmul8_a8": (8, 8, 2 ** -7, "int8")}
PLANNERS = {"quant_matmul4_a8": "plan_quant_matmul4_a8",
            "quant_matmul4": "plan_quant_matmul4",
            "quant_matmul8": "plan_quant_matmul8",
            "quant_matmul8_a8": "plan_quant_matmul8_a8"}


def check_matmul(torch, cfg, name, gs, ms_list=(4, 256, 2048),
                     lm_head=False):
    """One of MATMULS against its plain version at the projections
    of ``cfg`` (and its lm_head at M=4); ``gs=None`` is one INT8 scale per
    column.  W4A8 and the bf16-activation kernels are held to 2^-6 of the
    largest output: their f32 sums differ from the plain version's in
    order (the bf16 tensor cores' sums are not IEEE-ordered) and in the f32
    fold of each group or plane pair.  The W8A8 kernel's integer
    sums are exact, but the plain version's f32 sums are not, and both
    round to bf16: one bf16 ulp of the largest output (2^-7 of it) is its
    tolerance.  The library yardstick is torch.matmul in bf16 over the
    dequantized weight, and torch._int_mm for W8A8 where it takes the
    shape.  The split-K kernels print their plan, and at M <= 64 a call's
    device time in a CUDA graph beside torch.matmul's."""
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, dequantize
    from qwen_inference_engine_tpu_torch.quant.quantize import _padded_k

    bits, act_bits, rel, peak = MATMULS[name]
    kern = getattr(qm, name)
    plain = getattr(qm, name + "_plain")
    D, F, Qd, Kd = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim
    # the seven projections, and the offline-fused qkv and gateup
    # (quant/quantize.fuse_projections)
    shapes = [("q", D, Qd), ("k", D, Kd), ("v", D, Kd), ("o", Qd, D),
              ("gate", D, F), ("up", D, F), ("down", F, D),
              ("qkv", D, Qd + 2 * Kd), ("gateup", D, 2 * F)]
    cases = [(M, n, K, N) for M in ms_list for n, K, N in shapes
             if not (M > 4 and n in ("v", "up"))]  # same shapes as k / gate
    if lm_head:
        cases.append((4, "lm_head", D, cfg.vocab_size))
    g = torch.Generator(device="cuda").manual_seed(11)
    qmax = 7 if bits == 4 else 127
    label = f"{name} {'per column' if gs is None else f'gs {gs}'}"
    records = []
    for M, pname, K, N in cases:
        kp = _padded_k(K, bits, gs)
        g_rows = kp if gs is None else gs
        rows = kp // 2 if bits == 4 else kp
        lo, hi = (-128, 128) if bits == 4 else (-127, 128)
        q = torch.randint(lo, hi, (1, rows, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.full((1, kp // g_rows, N), K ** -0.5 / qmax, device="cuda")
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        xp = torch.nn.functional.pad(x, (0, kp - K))
        if act_bits:
            xq, sx = qm.quantize_activations(xp)
            args = (xq, sx.reshape(-1).contiguous(), q, s, 0)
        else:
            args = (xp, q, s, 0)
        args += (g_rows,) if bits == 4 else ()
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = rel * ref.float().abs().max().item()
        w = dequantize(QuantLinear(q=q[0], scales=s[0], b=None, bits=bits,
                                   group_size=g_rows))[:K]
        ms = time_ms(torch, lambda: kern(*args))
        plain_ms = time_ms(torch, lambda: plain(*args), iters=3, warmup=1)
        lib_ms = time_ms(torch, lambda: torch.matmul(x, w))
        int_mm_ms = None
        if act_bits and bits == 8 and M > 16:
            int_mm_ms = time_ms(torch, lambda: torch._int_mm(xq, q[0]))
        n_bytes = (M * kp * (1 if act_bits else 2) + 4 * M * (act_bits > 0)
                   + rows * N + 4 * (kp // g_rows) * N + 2 * M * N)
        b_ms, b_by = bound(n_bytes, 2 * M * kp * N, peak)
        rec = dict(shape=f"{cfg.name} {pname} M={M} K={kp} N={N}", M=M,
                   proj=pname, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, int_mm_ms=int_mm_ms,
                   bound_ms=b_ms, bound_by=b_by)
        extra = "" if int_mm_ms is None else f" | _int_mm {int_mm_ms:.4f}"
        if name in PLANNERS:  # the kernel's (mt, splits, slice)
            rec["plan"] = getattr(qm, PLANNERS[name])(
                M, kp, N, g_rows if bits == 4 else kp // g_rows)
            extra += f" | plan (mt, splits, slice) {rec['plan']}"
            if M <= 64:  # decode: a call's device time apart from the host's
                rec["graph_ms"] = graph_ms(torch, lambda: kern(*args))
                rec["library_graph_ms"] = graph_ms(
                    torch, lambda: torch.matmul(x, w))
                extra += (f" | in a CUDA graph: kernel {rec['graph_ms']:.4f}"
                          f", torch.matmul {rec['library_graph_ms']:.4f}")
        print(f"  {label} {rec['shape']}: err {err:.3g} (tol {tol:.3g}) | "
              f"kernel {ms:.4f} ms | plain {plain_ms:.4f} | torch.matmul bf16 "
              f"{lib_ms:.4f}{extra} | bound {b_ms:.4f} ({b_by})", flush=True)
        if not err <= tol:
            fail(f"{label} {rec['shape']} err {err} > {tol}")
        records.append(rec)
        del q, s, x, xp, w, got, ref, args
    return records


SPLIT_PROJS = ("q", "k", "v", "o", "gate", "up", "down")
FUSED_PROJS = ("qkv", "o", "gateup", "down")


def layer_at(recs, M, projs=SPLIT_PROJS):
    """The projections of one 7B layer at M rows, summed: the seven split
    ones (v and up, not timed past M = 4, count as k and gate), or with
    ``FUSED_PROJS`` the four of offline-fused parameters."""
    by = {r["proj"]: r for r in recs if r["M"] == M}
    by.setdefault("v", by["k"])
    by.setdefault("up", by["gate"])
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") + (
        ("graph_ms", "library_graph_ms") if "graph_ms" in by["q"] else ())
    return {k: sum(by[p][k] for p in projs) for k in keys}


def fused_plans(label, recs):
    """Print, at each M <= 64, the split-K plan of qkv beside q / k and of
    gateup beside gate: where they differ, the fused and split logits
    round apart in a decode step.  Returns {M: {proj: plan}}."""
    out = {}
    for M in sorted({r["M"] for r in recs if "plan" in r and r["M"] <= 64}):
        by = {r["proj"]: tuple(r["plan"]) for r in recs if r["M"] == M}
        out[M] = by
        same_qkv = by["qkv"] == by["q"] == by["k"]
        same_gu = by["gateup"] == by["gate"]
        print(f"[fused plans] {label} M={M}: qkv {by['qkv']} vs q {by['q']} "
              f"/ k {by['k']} ({'same' if same_qkv else 'differ'}); gateup "
              f"{by['gateup']} vs gate {by['gate']} "
              f"({'same' if same_gu else 'differ'})", flush=True)
    return out


def layer_record(recs, extra_err=()):
    """A matmul kernel's JSON entry: the seven projections of one 7B layer
    at M=4 (the decode step), summed."""
    dec = [r for r in recs if r["M"] == 4 and r.get("proj") in SPLIT_PROJS]
    b_bytes = sum(r["bound_ms"] for r in dec if r["bound_by"] == "bytes")
    total_bound = sum(r["bound_ms"] for r in dec)
    return dict(
        max_abs_err=max(r["max_abs_err"] for r in list(recs) + list(extra_err)),
        ms=sum(r["ms"] for r in dec), plain_ms=sum(r["plain_ms"] for r in dec),
        library_ms=sum(r["library_ms"] for r in dec), bound_ms=total_bound,
        bound_by="bytes" if b_bytes * 2 >= total_bound else "operations",
        unit="the 7 projections of one layer at M=4")


def _sdpa(torch, q, k, v, mask=None, causal=False):
    """The library yardstick: PyTorch's fused attention ([B, H, T, D])."""
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)


def check_flash(torch, cfg, cfg_moe):
    """flash_attention at the 7B prefill chunk (B 4, T 512; the first
    record), the serving piece that starts a sequence (B 1, T 256) and
    Qwen3-30B-A3B's G = 8 (B 4, T 512)."""
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(2)
    records = []
    for label, c, B, T in (("7B", cfg, 4, 512), ("7B serving piece", cfg, 1, 256),
                           ("30B-A3B", cfg_moe, 4, 512)):
        Hq, Hk, D = c.num_heads, c.num_kv_heads, c.head_dim
        q, k, v = (torch.randn((B, T, h, D), generator=g, device="cuda"
                               ).to(torch.bfloat16) for h in (Hq, Hk, Hk))
        got = fa.flash_attention(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2e-2
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v),
                           iters=3)
        lib_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2),
                                      k.transpose(1, 2), v.transpose(1, 2),
                                      causal=True))
        n_ops = 4 * D * B * Hq * T * (T + 1) // 2
        n_bytes = 2 * (2 * B * T * Hq * D) + 2 * (2 * B * T * Hk * D)
        b_ms, b_by = bound(n_bytes, n_ops, "bf16")
        rec = dict(shape=f"{label} B={B} T={T} Hq={Hq} Hk={Hk} D={D}",
                   max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   tflops=n_ops / ms / 1e9)
        print(f"  flash_attention {rec['shape']}: err {err:.3g} (tol {tol}) | "
              f"kernel {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s) | plain "
              f"{plain_ms:.4f} | sdpa {lib_ms:.4f} | bound {b_ms:.4f} "
              f"({b_by})", flush=True)
        if not err <= tol:
            fail(f"flash_attention {rec['shape']} err {err} > {tol}")
        records.append(rec)
        del q, k, v, got, ref
    return records


def check_decode(torch, cfg):
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da

    L, B, S = 2, 4, 1024
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    kc, vc = rnd(L, B, Hk, S, D), rnd(L, B, Hk, S, D)
    q = rnd(B, 1, Hq, D)
    kn, vn = rnd(B, 1, Hk, D), rnd(B, 1, Hk, D)
    layer = 1
    tol = 2e-2
    records = {}

    lens_list = [69, 152, 332, 1000]
    lens = torch.tensor(lens_list, device="cuda")
    got = da.decode_attention_contiguous(q, kc, vc, layer, lens)
    ref = da.decode_attention_contiguous_plain(q, kc, vc, layer, lens)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    twice = bool(torch.equal(
        got, da.decode_attention_contiguous(q, kc, vc, layer, lens)))
    ms = time_ms(torch, lambda: da.decode_attention_contiguous(q, kc, vc, layer, lens))
    g_ms = graph_ms(torch, lambda: da.decode_attention_contiguous(
        q, kc, vc, layer, lens))
    plain_ms = time_ms(torch, lambda: da.decode_attention_contiguous_plain(
        q, kc, vc, layer, lens))
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    sdpa = _sdpa(torch, q.transpose(1, 2), kc[layer], vc[layer], mask=mask)
    lib_ms = time_ms(torch, sdpa)
    lib_g_ms = graph_ms(torch, sdpa)
    n_keys = sum(lens_list)
    n_bytes = 2 * (2 * n_keys * Hk * D) + 2 * (2 * B * Hq * D) + 4 * B
    b_ms, b_by = bound(n_bytes, 4 * n_keys * Hq * D, "bf16")
    plan = da.plan_decode_split(B, Hk, S)
    ragged = records["decode_attention_contiguous"] = dict(
        shape=f"B={B} lens={lens_list} S={S} Hq={Hq} Hk={Hk}", max_abs_err=err,
        tol=tol, ms=ms, graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by, plan=plan)
    print(f"  decode_attention_contiguous lens {lens_list}: err {err:.3g} "
          f"(tol {tol}), two calls bit-identical {twice} | plan (span, "
          f"splits) {plan} | kernel {ms:.4f} ms | in a CUDA graph "
          f"{g_ms:.4f} | plain {plain_ms:.4f} | sdpa {lib_ms:.4f} (graph "
          f"{lib_g_ms:.4f}) | bound {b_ms:.4f} ({b_by})", flush=True)
    if not err <= tol or not twice:
        fail(f"decode_attention_contiguous err {err} > {tol} or two calls "
             f"differ")

    rec, out, (k1, v1) = _appending_record(
        torch, da, cfg, g, B, S, pos=999, L=L, layer=layer,
        inputs=(kc, vc, q, kn, vn))
    # the fresh decode at the same shape and position, over the cache the
    # appending call wrote: the same blocks on the same values, so its
    # output must equal the appending one bit for bit
    old = torch.full((B,), 999, dtype=torch.int32, device="cuda")
    fresh = da.decode_attention_contiguous_fresh(q, k1, v1, kn, vn, layer, old)
    same = bool(torch.equal(fresh, out))
    f_ms = time_ms(torch, lambda: da.decode_attention_contiguous_fresh(
        q, k1, v1, kn, vn, layer, old))
    f_g_ms = graph_ms(torch, lambda: da.decode_attention_contiguous_fresh(
        q, k1, v1, kn, vn, layer, old))
    print(f"  decode_attention_contiguous_fresh old lengths 999 (check_decode's "
          f"shape): bit-equal to the appending output {same} | kernel "
          f"{f_ms:.4f} ms | in a CUDA graph {f_g_ms:.4f}", flush=True)
    if not same:
        fail("decode_attention_contiguous_fresh differs from the appending "
             "kernel at one shared position")
    rec["at_fresh_b4"] = dict(ms=f_ms, graph_ms=f_g_ms, bit_equal=same)
    ragged["appending_bit_equal_b4"] = _ragged_equals_appending(
        torch, da, q, k1, v1, layer, 999, out)
    del k1, v1, out
    # the batch-192 default dispatch's shape (W4A16 pad-free, S 512, the
    # middle of its 32 decode steps): one split, no merge launch
    pos, nb = PUMP_PROMPT + 16, PUMP_BATCH
    inputs = (rnd(L, nb, Hk, PUMP_SEQ, D), rnd(L, nb, Hk, PUMP_SEQ, D),
              rnd(nb, 1, Hq, D), rnd(nb, 1, Hk, D), rnd(nb, 1, Hk, D))
    rec["at_b192"], out, (k1, v1) = _appending_record(
        torch, da, cfg, g, nb, PUMP_SEQ, pos=pos, L=L, layer=layer,
        inputs=inputs)
    ragged["appending_bit_equal_b192"] = _ragged_equals_appending(
        torch, da, inputs[2], k1, v1, layer, pos, out)
    del k1, v1, out, inputs
    records["decode_attention_appending"] = rec
    return records


def _ragged_equals_appending(torch, da, q, kc, vc, layer, pos, appended):
    """The ragged decode at lengths pos + 1 over the cache the appending
    decode wrote at ``pos`` (its output ``appended``) runs the same blocks
    on the same bits: fails unless the outputs are bit-equal."""
    B = q.shape[0]
    lens = torch.full((B,), pos + 1, dtype=torch.int32, device="cuda")
    same = bool(torch.equal(
        da.decode_attention_contiguous(q, kc, vc, layer, lens), appended))
    print(f"  decode_attention_contiguous B={B} lengths {pos + 1} (plan "
          f"{da.plan_decode_split(B, kc.shape[2], kc.shape[3])}): bit-equal "
          f"to the appending output at position {pos} {same}", flush=True)
    if not same:
        fail(f"decode_attention_contiguous B={B} differs from the appending "
             f"decode at lengths = position + 1")
    return same


def _appending_record(torch, da, cfg, g, B, S, pos, L, layer, inputs=None):
    """decode_attention_appending at (B, S, pos) of Qwen2.5-7B's heads over
    ``inputs`` (kc, vc, q, kn, vn; random from ``g`` when None) against its
    plain version (2e-2; the written cache rows bit-exact; two calls
    bit-identical), with its split plan, a call's time and a CUDA graph's
    beside SDPA's (over the first pos + 1 keys, no write) and the byte
    bound.  Returns (record, output, the caches it wrote)."""
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    if inputs is None:
        inputs = (rnd(L, B, Hk, S, D), rnd(L, B, Hk, S, D), rnd(B, 1, Hq, D),
                  rnd(B, 1, Hk, D), rnd(B, 1, Hk, D))
    kc, vc, q, kn, vn = inputs
    tol = 2e-2
    k1, v1 = kc.clone(), vc.clone()
    k2, v2 = kc.clone(), vc.clone()
    got, gk, gv = da.decode_attention_appending(q, k1, v1, kn, vn, layer, pos)
    ref, rk, rv = da.decode_attention_appending_plain(q, k2, v2, kn, vn, layer, pos)
    torch.cuda.synchronize()
    if gk is not k1 or gv is not v1:
        fail("decode_attention_appending did not return the caches it wrote")
    err = (got.float() - ref.float()).abs().max().item()
    cache_err = max((gk.float() - rk.float()).abs().max().item(),
                    (gv.float() - rv.float()).abs().max().item())
    del k2, v2, rk, rv
    ms = time_ms(torch, lambda: da.decode_attention_appending(
        q, k1, v1, kn, vn, layer, pos))
    g_ms = graph_ms(torch, lambda: da.decode_attention_appending(
        q, k1, v1, kn, vn, layer, pos))
    k2, v2 = kc.clone(), vc.clone()
    plain_ms = time_ms(torch, lambda: da.decode_attention_appending_plain(
        q, k2, v2, kn, vn, layer, pos), iters=3, warmup=1)
    del k2, v2
    sdpa = _sdpa(torch, q.transpose(1, 2), kc[layer, :, :, :pos + 1],
                 vc[layer, :, :, :pos + 1])
    lib_ms = time_ms(torch, sdpa)
    lib_g_ms = graph_ms(torch, sdpa)
    n_keys = B * (pos + 1)
    n_bytes = 2 * (2 * n_keys * Hk * D) + 2 * (2 * B * Hq * D) + 2 * (2 * B * Hk * D)
    b_ms, b_by = bound(n_bytes, 4 * n_keys * Hq * D, "bf16")
    plan = da.plan_decode_split(B, Hk, S)
    print(f"  decode_attention_appending B={B} position {pos} of S {S}: err "
          f"{err:.3g} (tol {tol}), cache rows err {cache_err} | plan (span, "
          f"splits) {plan} | kernel {ms:.4f} ms | in a CUDA graph "
          f"{g_ms:.4f} | plain {plain_ms:.4f} | sdpa {lib_ms:.4f} (graph "
          f"{lib_g_ms:.4f}) | bound {b_ms:.4f} ({b_by})", flush=True)
    again, _, _ = da.decode_attention_appending(q, k1, v1, kn, vn, layer, pos)
    same = bool(torch.equal(again, got))
    if not err <= tol or cache_err != 0 or not same:
        fail(f"decode_attention_appending B={B} err {err} (tol {tol}), "
             f"cache {cache_err}, two calls bit-identical {same}")
    rec = dict(shape=f"B={B} position={pos} S={S} Hq={Hq} Hk={Hk}",
               max_abs_err=err, cache_err=cache_err, tol=tol, ms=ms,
               graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by,
               plan=plan)
    return rec, got, (k1, v1)


def _int8(torch, g, shape):
    from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

    return quantize_kv(torch.randn(shape, generator=g, device="cuda"))


def check_chunk(torch, cfg):
    """Kernels 5 and 6: the continuation chunk at B=4, T=512 over a cache
    of S=2304, starts 512, 1024 and 1536 (chunks 1-3 of a 2048 bucket).
    Returns {name: the start-1536 record, with every start's record under
    "start_<start>"}."""
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.quant.kv_quant import dequantize_kv

    L, B, T, S = 2, 4, 512, 2304
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((B, T, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    kc = torch.randn((L, B, Hk, S, D), generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn((L, B, Hk, S, D), generator=g, device="cuda").to(torch.bfloat16)
    k8, ks = _int8(torch, g, (L, B, Hk, S, D))
    v8, vs = _int8(torch, g, (L, B, Hk, S, D))
    layer = 1
    records = {}
    for quant in (False, True):
        name = "chunk_attention_contiguous" + ("_q8" if quant else "")
        tol = 2e-2
        for start in (512, 1024, 1536):
            end = start + T
            if quant:
                args = (q, k8, v8, ks, vs, layer, start)
                kern, plain = ca.chunk_attention_contiguous_q8, \
                    ca.chunk_attention_contiguous_q8_plain
                # the library's input: a bf16 copy dequantized beforehand
                kl = dequantize_kv(k8[layer, :, :, :end], ks[layer, :, :, :end])
                vl = dequantize_kv(v8[layer, :, :, :end], vs[layer, :, :, :end])
            else:
                args = (q, kc, vc, layer, start)
                kern, plain = ca.chunk_attention_contiguous, \
                    ca.chunk_attention_contiguous_plain
                kl, vl = kc[layer, :, :, :end], vc[layer, :, :, :end]
            got = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ms = time_ms(torch, lambda: kern(*args))
            plain_ms = time_ms(torch, lambda: plain(*args), iters=3, warmup=1)
            qpos = start + torch.arange(T, device="cuda")
            mask = torch.arange(end, device="cuda")[None, :] <= qpos[:, None]
            lib_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2), kl, vl,
                                          mask=mask))
            itemsize = 1 if quant else 2
            n_bytes = 2 * B * Hk * end * D * itemsize + 2 * 2 * B * T * Hq * D
            if quant:
                n_bytes += 2 * 4 * B * Hk * end
            n_ops = 4 * B * Hq * D * (T * start + T * (T + 1) // 2)
            b_ms, b_by = bound(n_bytes, n_ops, "bf16")
            rec = dict(shape=f"B={B} T={T} start={start} S={S} Hq={Hq} "
                             f"Hk={Hk} D={D}", max_abs_err=err, tol=tol, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            print(f"  {name} start {start}: err {err:.3g} (tol {tol}) | "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} | sdpa "
                  f"{lib_ms:.4f} | bound {b_ms:.4f} ({b_by})", flush=True)
            if not err <= tol:
                fail(f"{name} start {start} err {err} > {tol}")
            records.setdefault(name, {})[f"start_{start}"] = rec
            del got, ref, kl, vl
        # the JSON line's main numbers: the last chunk of the 2048 bucket
        records[name].update(records[name]["start_1536"])
    return records


def check_chunk_rows(torch, cfg):
    """Kernels 5 and 6 with per-row starts read on the device, as the
    fixed-batch speculative verify (``[generate spec]``) calls them: B=4,
    T = 5 and 16 over S=2048, rows at 0, mid-tile, mid-cache and S - T (a
    window that ends at the cache's end).  The kernel reads a cache with
    NaN past each row's window (NaN scales for int8); the plain version
    reads the same cache without them (it masks those keys).  Returns
    {name: {"rows_T5": record, "rows_T16": record}}."""
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.quant.kv_quant import dequantize_kv

    L, B, S, layer = 2, 4, 2048, 1
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(9)
    kc = torch.randn((L, B, Hk, S, D), generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn((L, B, Hk, S, D), generator=g, device="cuda").to(torch.bfloat16)
    k8, ks = _int8(torch, g, (L, B, Hk, S, D))
    v8, vs = _int8(torch, g, (L, B, Hk, S, D))
    nan = float("nan")
    tol = 2e-2
    records = {}
    for T in (SPEC_T, 16):
        starts_list = [0, 100, 1290, S - T]
        starts = torch.tensor(starts_list, dtype=torch.int32, device="cuda")
        q = torch.randn((B, T, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
        past = torch.arange(S, device="cuda")[None, :] >= (starts.long() + T)[:, None]
        end = max(starts_list) + T
        qpos = starts.long()[:, None] + torch.arange(T, device="cuda")[None, :]
        mask = (torch.arange(end, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]          # [B, 1, T, end]
        n_keys = sum(s + T for s in starts_list)
        n_ops = 4 * Hq * D * sum(T * s + T * (T + 1) // 2 for s in starts_list)
        for quant in (False, True):
            name = "chunk_attention_contiguous" + ("_q8" if quant else "")
            if quant:
                ksn, vsn = ks.clone(), vs.clone()
                for t in (ksn, vsn):
                    t[layer].masked_fill_(past[:, None, :], nan)
                kern, plain = ca.chunk_attention_contiguous_q8, \
                    ca.chunk_attention_contiguous_q8_plain
                args = (q, k8, v8, ksn, vsn, layer, starts)
                args_plain = (q, k8, v8, ks, vs, layer, starts)
                kl = dequantize_kv(k8[layer, :, :, :end], ks[layer, :, :, :end])
                vl = dequantize_kv(v8[layer, :, :, :end], vs[layer, :, :, :end])
            else:
                kn, vn = kc.clone(), vc.clone()
                for t in (kn, vn):
                    t[layer].masked_fill_(past[:, None, :, None], nan)
                kern, plain = ca.chunk_attention_contiguous, \
                    ca.chunk_attention_contiguous_plain
                args = (q, kn, vn, layer, starts)
                args_plain = (q, kc, vc, layer, starts)
                kl, vl = kc[layer, :, :, :end], vc[layer, :, :, :end]
            got = kern(*args)
            ref = plain(*args_plain)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ms = time_ms(torch, lambda: kern(*args))
            plain_ms = time_ms(torch, lambda: plain(*args_plain))
            lib_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2), kl, vl,
                                          mask=mask))
            itemsize = 1 if quant else 2
            n_bytes = (2 * n_keys * Hk * D * itemsize + 2 * 2 * B * T * Hq * D
                       + 4 * B + (2 * 4 * n_keys * Hk if quant else 0))
            b_ms, b_by = bound(n_bytes, n_ops, "bf16")
            rec = dict(shape=f"B={B} T={T} per-row starts {starts_list} S={S} "
                             f"Hq={Hq} Hk={Hk} D={D}", max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            print(f"  {name} per-row starts {starts_list} T={T} (NaN past each"
                  f" window): err {err:.3g} (tol {tol}) | kernel {ms:.4f} ms |"
                  f" plain {plain_ms:.4f} | sdpa {lib_ms:.4f} | bound "
                  f"{b_ms:.5f} ({b_by})", flush=True)
            if not err <= tol:
                fail(f"{name} per-row starts T={T} err {err} > {tol}")
            records.setdefault(name, {})[f"rows_T{T}"] = rec
            del got, ref, args, kl, vl
    return records


def check_kv_append(torch, cfg):
    """Kernel 7 at B=4, position 1999 of S=2304: bit-exact, bytes and
    scales.  A call and in a CUDA graph, beside the slice assignment's
    graph; the plan the row kernel took."""
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

    L, B, S, pos, layer = 2, 4, 2304, 1999, 1
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(5)
    k8, ks = _int8(torch, g, (L, B, Hk, S, D))
    v8, vs = _int8(torch, g, (L, B, Hk, S, D))
    kn, ksn = quantize_kv(torch.randn((B, 1, Hk, D), generator=g, device="cuda"))
    vn, vsn = quantize_kv(torch.randn((B, 1, Hk, D), generator=g, device="cuda"))
    new = (kn, vn, ksn, vsn)
    mine = [t.clone() for t in (k8, v8, ks, vs)]
    theirs = [t.clone() for t in (k8, v8, ks, vs)]
    got = ka.kv_append_uniform_q8(*mine, *new, pos, layer)
    ref = ka.kv_append_uniform_q8_plain(*theirs, *new, pos, layer)
    torch.cuda.synchronize()
    if any(a is not b for a, b in zip(got, mine)):
        fail("kv_append_uniform_q8 did not return the tensors it wrote")
    diff = sum(int((a != b).sum()) for a, b in zip(got, ref))
    written = int((mine[0] != k8).sum())
    # int32, as the kernel reads it: no cast launched beside each call
    pos_t = torch.tensor([pos], device="cuda", dtype=torch.int32)
    ms = time_ms(torch, lambda: ka.kv_append_uniform_q8(*mine, *new, pos_t, layer))
    plain_ms = time_ms(torch, lambda: ka.kv_append_uniform_q8_plain(
        *theirs, *new, pos, layer))

    def library():
        for cache, x in zip(theirs, new):
            cache[layer, :, :, pos] = x[:, 0]

    g_ms = graph_ms(torch, lambda: ka.kv_append_uniform_q8(*mine, *new, pos_t,
                                                           layer))
    lib_ms = time_ms(torch, library)
    lib_g_ms = graph_ms(torch, library)
    n_bytes = 2 * (2 * B * Hk * D + 2 * 4 * B * Hk)
    b_ms, b_by = bound(n_bytes, 0, "int8")
    plan = ka.plan_paged_append(B, 1, Hk, D, 1, True)
    print(f"  kv_append_uniform_q8 position {pos}: {diff} elements differ "
          f"(must be 0, scales included; {written} K bytes written) | plan "
          f"(vec, threads, blocks) {plan} | kernel {ms:.4f} ms (graph "
          f"{g_ms:.5f}) | plain {plain_ms:.4f} | slice assignment "
          f"{lib_ms:.4f} (graph {lib_g_ms:.5f}) | bound {b_ms:.6f} ({b_by})",
          flush=True)
    if diff != 0 or written == 0:
        fail(f"kv_append_uniform_q8 not bit-exact: {diff} elements differ")
    return {"kv_append_uniform_q8": dict(
        shape=f"B={B} position={pos} S={S} Hk={Hk} D={D}", max_abs_err=0.0,
        tol=0.0, ms=ms, graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by,
        kernel=f"append_rows_kernel (contiguous rows, one position), plan "
               f"{plan}")}


def check_decode_q8(torch, cfg):
    """Kernel 8 (split S on the tensor cores, then a merge) at B=4,
    lengths 69 / 700 / 1408 / 2000 of S=2304, and at the INT8 main path's
    own decode (run (c): B = 4, lengths 37 / 120 / 300 / 500 of S 1024).
    Each shape prints its split plan (span, splits) and a call's device
    time in a CUDA graph beside SDPA's over a copy dequantized beforehand;
    two calls must be bit-identical."""
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.quant.kv_quant import dequantize_kv

    L, B, layer = 2, 4, 1
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(6)
    tol = 2e-2
    recs = {}
    for S, lens_list in ((2304, [69, 700, 1408, 2000]),
                         (RAGGED_S, [37, 120, 300, 500])):
        k8, ks = _int8(torch, g, (L, B, Hk, S, D))
        v8, vs = _int8(torch, g, (L, B, Hk, S, D))
        q = torch.randn((B, 1, Hq, D), generator=g,
                        device="cuda").to(torch.bfloat16)
        lens = torch.tensor(lens_list, device="cuda")
        args = (q, k8, v8, ks, vs, layer, lens)
        got = da.decode_attention_contiguous_q8(*args)
        again = da.decode_attention_contiguous_q8(*args)
        ref = da.decode_attention_contiguous_q8_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        same = bool(torch.equal(got, again))
        ms = time_ms(torch, lambda: da.decode_attention_contiguous_q8(*args))
        g_ms = graph_ms(torch, lambda: da.decode_attention_contiguous_q8(*args))
        plain_ms = time_ms(torch, lambda: da.decode_attention_contiguous_q8_plain(
            *args))
        kl = dequantize_kv(k8[layer], ks[layer])
        vl = dequantize_kv(v8[layer], vs[layer])
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        sdpa = _sdpa(torch, q.transpose(1, 2), kl, vl, mask=mask)
        lib_ms = time_ms(torch, sdpa)
        lib_g_ms = graph_ms(torch, sdpa)
        n_keys = sum(lens_list)
        n_bytes = 2 * n_keys * Hk * (D + 4) + 2 * (2 * B * Hq * D) + 4 * B
        b_ms, b_by = bound(n_bytes, 4 * n_keys * Hq * D, "bf16")
        plan = da.plan_decode_split(B, Hk, S)
        print(f"  decode_attention_contiguous_q8 lens {lens_list} S {S}: err "
              f"{err:.3g} (tol {tol}), two calls bit-identical {same} | plan "
              f"(span, splits) {plan} | kernel {ms:.4f} ms | in a CUDA graph "
              f"{g_ms:.4f} | plain {plain_ms:.4f} | sdpa {lib_ms:.4f} (graph "
              f"{lib_g_ms:.4f}) | bound {b_ms:.4f} ({b_by})", flush=True)
        if not (err <= tol and same):
            fail(f"decode_attention_contiguous_q8 S {S} err {err} > {tol} or "
                 f"two calls differ")
        recs[S] = dict(
            shape=f"B={B} lens={lens_list} S={S} Hq={Hq} Hk={Hk}",
            max_abs_err=err, tol=tol, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
            library_ms=lib_ms, library_graph_ms=lib_g_ms, bound_ms=b_ms,
            bound_by=b_by, plan=plan)
        del k8, v8, ks, vs, kl, vl
    return {"decode_attention_contiguous_q8": dict(
        recs[2304], at_main_path=recs[RAGGED_S])}


# the pipeline's 1F1B decode ([pp 1f1b], phase 9): 8 rows, one microbatch
# of 8 / S rows a stage at pp = S, over a cache of PP_1F1B_SEQ positions
PP_WAVE = 8
PP_STAGES = (2, 4)
PP_PROMPT = 128
PP_STEPS = 16
PP_1F1B_SEQ = 256
# the four wrappers that take the 1F1B row window (row0)
ROW0_KERNELS = ("decode_attention_appending", "decode_attention_contiguous",
                "decode_attention_contiguous_q8", "kv_append_uniform_q8")


def _row0_call(da, ka, name, q, caches, new, layer, pos, lens, row0):
    """One call of a row0 wrapper (``caches`` written in place where it
    writes); returns its output (None for the append)."""
    if name == "decode_attention_appending":
        return da.decode_attention_appending(q, *caches, *new[:2], layer, pos,
                                             row0=row0)[0]
    if name == "decode_attention_contiguous":
        return da.decode_attention_contiguous(q, *caches, layer, lens,
                                              row0=row0)
    if name == "decode_attention_contiguous_q8":
        return da.decode_attention_contiguous_q8(q, *caches, layer, lens,
                                                 row0=row0)
    ka.kv_append_uniform_q8(*caches, *new, pos, layer, row0=row0)
    return None


def _row0_plain(da, ka, name, q, caches, new, layer, pos, lens, row0):
    if name == "decode_attention_appending":
        return da.decode_attention_appending_plain(q, *caches, *new[:2],
                                                   layer, pos, row0)[0]
    if name == "decode_attention_contiguous":
        return da.decode_attention_contiguous_plain(q, *caches, layer, lens,
                                                    row0)
    if name == "decode_attention_contiguous_q8":
        return da.decode_attention_contiguous_q8_plain(q, *caches, layer,
                                                       lens, row0)
    ka.kv_append_uniform_q8_plain(*caches, *new, pos, layer, row0)
    return None


def check_row0_kernels(torch, cfg):
    """The four row0 variants at the 1F1B shapes ([pp 1f1b]: Qwen2.5-7B's
    heads, b = 8 / S rows of a cache of Bc = 8 at pp = S = 2 and 4, S
    PP_1F1B_SEQ, position 136), at row0 = m b for every microbatch m: each
    output and written cache bit-equal to the same call at row0 = 0 on a
    Bc = b copy of the window's rows, every other row untouched, the
    output within its phase-3 rule of the plain version (2e-2; the INT8
    append bit for bit).  At row0 = b each is timed a call and in a CUDA
    graph beside its plain version and its library yardstick (SDPA over the
    window's keys; a slice assignment for the append) with the rows' bytes
    over 3.35 TB/s as the bound.  Returns {wrapper: {"pp<S>": record}}."""
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.quant.kv_quant import (
        dequantize_kv,
        quantize_kv,
    )

    L, Bc, S, pos, layer = 2, PP_WAVE, PP_1F1B_SEQ, PP_PROMPT + 8, 1
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(26)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    bf = [rnd(L, Bc, Hk, S, D), rnd(L, Bc, Hk, S, D)]
    k8, ks = _int8(torch, g, (L, Bc, Hk, S, D))
    v8, vs = _int8(torch, g, (L, Bc, Hk, S, D))
    i8 = [k8, v8, ks, vs]
    records = {n: {} for n in ROW0_KERNELS}
    for stages in PP_STAGES:
        b = Bc // stages
        for name in ROW0_KERNELS:
            quant = name.endswith("q8")
            worst, timed = 0.0, None
            for m in range(stages):
                row0 = m * b
                q = rnd(b, 1, Hq, D)
                kn, vn = rnd(b, 1, Hk, D), rnd(b, 1, Hk, D)
                if name == "kv_append_uniform_q8":
                    (qk, sk), (qv, sv) = quantize_kv(kn), quantize_kv(vn)
                    new = (qk, qv, sk, sv)
                else:
                    new = (kn, vn)
                lens = torch.tensor([pos + 1 - 7 * i for i in range(b)],
                                    device="cuda", dtype=torch.int32)
                before = [t.clone() for t in (i8 if quant else bf)]
                full = [t.clone() for t in before]
                win = [t[:, row0:row0 + b].contiguous() for t in before]
                got = _row0_call(da, ka, name, q, full, new, layer, pos, lens,
                                 row0)
                want = _row0_call(da, ka, name, q, win, new, layer, pos, lens,
                                  0)
                plain_caches = [t.clone() for t in before]
                ref = _row0_plain(da, ka, name, q, plain_caches, new, layer,
                                  pos, lens, row0)
                torch.cuda.synchronize()
                rest = torch.ones(Bc, dtype=torch.bool, device="cuda")
                rest[row0:row0 + b] = False
                same = (got is None or torch.equal(got, want)) and all(
                    torch.equal(f[:, row0:row0 + b], w)
                    for f, w in zip(full, win)) and all(
                    torch.equal(f[:, rest], o[:, rest])
                    for f, o in zip(full, before))
                if got is None:
                    err = float(sum(int((f != p).sum())
                                    for f, p in zip(full, plain_caches)))
                    tol = 0.0
                else:
                    err = (got.float() - ref.float()).abs().max().item()
                    tol = 2e-2
                worst = max(worst, err)
                if not (same and err <= tol):
                    fail(f"{name} pp={stages} row0 {row0}: bit-equal to its "
                         f"row slice at row0 0 {same}, vs plain {err} (tol "
                         f"{tol})")
                if m == 1:
                    timed = (q, new, lens, full, row0)
                del before, full, win, plain_caches
            q, new, lens, full, row0 = timed
            args = (da, ka, name, q, full, new, layer, pos, lens, row0)
            ms = time_ms(torch, lambda: _row0_call(*args))
            g_ms = graph_ms(torch, lambda: _row0_call(*args))
            pc = [t.clone() for t in full]
            plain_ms = time_ms(torch, lambda: _row0_plain(
                da, ka, name, q, pc, new, layer, pos, lens, row0), iters=3,
                warmup=1)
            rows = slice(row0, row0 + b)
            if name == "kv_append_uniform_q8":
                def lib():
                    for c, x in zip(pc, new):
                        c[layer, rows, :, pos] = x[:, 0]
                n_keys = 0
                n_bytes = 2 * (2 * b * Hk * D + 2 * 4 * b * Hk)
            else:
                if quant:
                    kl = dequantize_kv(full[0][layer, rows], full[2][layer, rows])
                    vl = dequantize_kv(full[1][layer, rows], full[3][layer, rows])
                else:
                    kl, vl = full[0][layer, rows], full[1][layer, rows]
                n = pos + 1
                lib = _sdpa(torch, q.transpose(1, 2), kl[:, :, :n],
                            vl[:, :, :n])
                n_keys = (b * (pos + 1) if name == "decode_attention_appending"
                          else int(lens.sum()))
                kv_bytes = (D + 4) if quant else 2 * D
                n_bytes = 2 * n_keys * Hk * kv_bytes + 2 * (2 * b * Hq * D)
                if name == "decode_attention_appending":
                    n_bytes += 2 * (2 * b * Hk * D)
            lib_ms = time_ms(torch, lib)
            lib_g_ms = graph_ms(torch, lib)
            b_ms, b_by = bound(n_bytes, 4 * n_keys * Hq * D,
                               "int8" if name == "kv_append_uniform_q8"
                               else "bf16")
            print(f"  {name} row0 (pp={stages}: {b} rows of {Bc}, S {S}, "
                  f"position {pos}) at row0 = m x {b}, m < {stages}: "
                  f"bit-equal to its row slice at row0 0, other rows "
                  f"untouched, vs plain {worst:.3g} | at row0 {row0}: kernel "
                  f"{ms:.4f} ms | in a CUDA graph {g_ms:.5f} | plain "
                  f"{plain_ms:.4f} | {'sdpa' if n_keys else 'slice assignment'}"
                  f" {lib_ms:.4f} (graph {lib_g_ms:.5f}) | bound "
                  f"{b_ms:.6f} ({b_by})", flush=True)
            records[name][f"pp{stages}"] = dict(
                shape=f"b={b} of Bc={Bc} row0={row0} position={pos} S={S} "
                      f"Hq={Hq} Hk={Hk}", max_abs_err=worst, bit_equal=True,
                ms=ms, graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by)
            del timed, full, pc
    return records


PAGE = 512          # the serving page size (scheduler default)
SERVE_MAX_PAGES = 64  # the scheduler's default max_pages_per_seq
PAGED_LENS = [1, 37, 300, 511, 512, 513, 1100, 1440]


PAGED_TOL = 2 ** -6


def rel_err(got, ref) -> float:
    """The largest error of any output vector (one query row and head) over
    that vector's largest |value|: the bf16 rounding of both sides moves it
    by at most 2**-7, so PAGED_TOL leaves a factor 2."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _stale(torch, k, v, tables, valid):
    """NaN into every row at or past ``valid[b]`` of table row b's pages:
    stale rows inside held pages, which the kernels must never load."""
    j = torch.arange(tables.shape[1] * PAGE, device="cuda")
    for b, n in enumerate(valid):
        jj = j[n:]
        pg = tables[b].long()[jj // PAGE]
        k[:, pg, :, jj % PAGE] = float("nan")
        v[:, pg, :, jj % PAGE] = float("nan")


def _paged_pool(torch, cfg, g, L=2, P=40, max_pages=4, rows=8):
    """A bf16 pool of P pages, NaN in every page no row's table holds, and
    tables of ``rows`` rows shuffled across pages 1..P-1."""
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    k = torch.randn((L, P, Hk, PAGE, D), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((L, P, Hk, PAGE, D), generator=g, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(P - 1, generator=g, device="cuda")[:rows * max_pages] + 1
    tables = perm.reshape(rows, max_pages).to(torch.int32)
    unused = torch.ones(P, dtype=torch.bool, device="cuda")
    unused[tables.reshape(-1).long()] = False
    k[:, unused] = float("nan")
    v[:, unused] = float("nan")
    return k, v, tables


def check_paged_decode(torch, cfg):
    """Paged decode at 8 slots, lengths 1..1440 over pages of 512, NaN in
    the pages no table holds and in each row's pages past its length: the
    tables of the pages the rows hold (4 pages), then the same pool
    through tables of the default serving width (64 pages of 512, zero
    past each row's pages, as the scheduler passes them), with
    each plan and how many splits of the 1440-key row hold keys; then
    check_paged_layouts."""
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    Hq, D = cfg.num_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(7)
    k, v, tables = _paged_pool(torch, cfg, g)
    _stale(torch, k, v, tables, PAGED_LENS)
    B = len(PAGED_LENS)
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    name = "paged_decode_attention_stacked"
    rec = paged_attention_case(
        torch, name, pa.paged_decode_attention_stacked,
        pa.paged_decode_attention_plain, q, (k, v), (), tables, PAGED_LENS)
    wide = torch.zeros((B, SERVE_MAX_PAGES), dtype=torch.int32, device="cuda")
    wide[:, :tables.shape[1]] = tables
    rec["at_default_width"] = paged_attention_case(
        torch, name + " (default width)", pa.paged_decode_attention_stacked,
        pa.paged_decode_attention_plain, q, (k, v), (), wide, PAGED_LENS)
    for r in (rec, rec["at_default_width"]):
        span, _, _ = r["plan"]
        r["splits_holding_keys_1440"] = -(-max(PAGED_LENS) // span)
    print(f"  {name} 8 slots at the default width ({SERVE_MAX_PAGES} pages "
          f"of {PAGE}): plan (span, splits, row_groups) "
          f"{rec['at_default_width']['plan']}, the 1440-key row in "
          f"{rec['at_default_width']['splits_holding_keys_1440']} split(s); "
          f"at {tables.shape[1]} pages {rec['plan']}, in "
          f"{rec['splits_holding_keys_1440']}", flush=True)
    if rec["splits_holding_keys_1440"] < 2:
        fail(f"{name}: the {tables.shape[1]}-page tables leave the 1440-key row in one "
             f"split ({rec['plan']})")
    rec["layouts"] = check_paged_layouts(torch, cfg)
    return {name: rec}


def check_paged_layouts(torch, cfg):
    """The bf16 paged decode over one cache stored as pages of 512 and of
    16, in order (identity tables, max_pages * page = S) and shuffled: one
    plan (the contiguous decode's: it depends on S alone) and the same
    arithmetic a row, so the bits of decode_attention_contiguous over the
    cache itself through every layout, at check_decode's ragged lengths.
    Then the serving verify's rows (T = 5, one row group) bit-equal to the
    decode of each token over the same pages, what a drafter equal to the
    target relies on."""
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    L, B, S, layer = 2, 4, RAGGED_S, 1
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(17)
    kc, vc = (torch.randn((L, B, Hk, S, D), generator=g, device="cuda"
                          ).to(torch.bfloat16) for _ in range(2))
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    lens = torch.tensor([69, 152, 332, 1000], device="cuda", dtype=torch.int32)
    want = da.decode_attention_contiguous(q, kc, vc, layer, lens)
    outs = {}
    for page in (512, 16):
        n = S // page
        for shuffle in (False, True):
            order = (torch.randperm(B * n, generator=g, device="cuda")
                     if shuffle else torch.arange(B * n, device="cuda"))

            def pool(c):
                rows = c.reshape(L, B, Hk, n, page, D).permute(
                    0, 1, 3, 2, 4, 5).reshape(L, B * n, Hk, page, D)
                out = torch.empty_like(
                    rows, memory_format=torch.contiguous_format)
                out[:, order] = rows
                return out

            tables = order.to(torch.int32).reshape(B, n)
            outs[(page, shuffle)] = pa.paged_decode_attention_stacked(
                q, pool(kc), pool(vc), tables, lens, page, layer)
    first = outs[(512, False)]
    same = all(torch.equal(o, first) for o in outs.values())
    equal = torch.equal(first, want)
    rel = rel_err(first, want)
    plan = pa.plan_paged_split(B, Hk, 1, S)
    print(f"  paged_decode_attention_stacked one cache as pages of 512 and "
          f"16, in order and shuffled, lens {lens.tolist()} of S {S} (plan "
          f"{plan}, decode_attention_contiguous's "
          f"{da.plan_decode_split(B, Hk, S)}): the same bits through every "
          f"layout {same}; bit-equal to decode_attention_contiguous {equal} "
          f"(relative {rel:.3g})", flush=True)
    if not (same and equal) or plan != da.plan_decode_split(B, Hk, S):
        fail(f"paged_decode_attention_stacked: layouts give other bits "
             f"({same}), or not the bits of decode_attention_contiguous "
             f"({rel} from it)")
    # the verify's rows against the decode of each token
    gp = torch.Generator(device="cuda").manual_seed(18)
    k, v, ptables = _paged_pool(torch, cfg, gp)
    vlens = verify_lens(SPEC_T)
    _stale(torch, k, v, ptables, vlens)
    qv = torch.randn((len(vlens), SPEC_T, Hq, D), generator=gp,
                     device="cuda").to(torch.bfloat16)
    vl = torch.tensor(vlens, device="cuda", dtype=torch.int32)
    rows = pa.paged_verify_attention_stacked(qv, k, v, ptables, vl, PAGE,
                                             layer)
    rows_same = all(torch.equal(pa.paged_decode_attention_stacked(
        qv[:, t:t + 1].contiguous(), k, v, ptables, vl - SPEC_T + t + 1,
        PAGE, layer)[:, 0], rows[:, t]) for t in range(SPEC_T))
    print(f"  paged_verify_attention_stacked T={SPEC_T}: every row bit-equal "
          f"to the decode of its token {rows_same}", flush=True)
    if not rows_same:
        fail("paged_verify_attention_stacked: a row differs from the decode "
             "of its token")
    return dict(layouts_bit_equal=same, bit_equal_contiguous=equal,
                rel_err_vs_contiguous=rel,
                verify_rows_equal_decode=rows_same)


def _q8_pool(torch, k, v):
    """The int8 pool of a bf16 pool (``quantize_kv`` per token and head):
    (k8, v8, k_scale, v_scale); rows that hold NaN get NaN scales, so a
    kernel that loaded a stale row's scale would show it."""
    from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

    out = []
    for x in (k, v):
        q, sc = quantize_kv(x.nan_to_num())
        sc[x.isnan().any(-1)] = float("nan")
        out.append((q, sc))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _pool_bytes(pools, scales, n_keys, Hk, D) -> int:
    """Bytes of n_keys keys' K and V (and their scales for int8)."""
    n = 2 * n_keys * Hk * D * pools[0].element_size()
    return n + (2 * n_keys * Hk * 4 if scales else 0)


def paged_attention_case(torch, name, kern, plain, q, pools, scales, tables,
                         lens_list, layer=1):
    """One paged decode / verify kernel against its plain version: q [B, T,
    Hq, D], token t of row b at lens[b] - T + t.  Two calls must be
    bit-identical.  Timed a call and in a CUDA graph; the library
    yardstick is SDPA over a gathered (and, for int8, dequantized) copy, a
    call and in a graph, the gather beside it.  Returns the JSON record,
    with the plan (span, splits, row_groups)."""
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    B, T, Hq, D = q.shape
    Hk = pools[0].shape[2]
    lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
    args = (q, *pools, *scales, tables, lens, PAGE, layer)
    got = kern(*args)
    again = kern(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    rel = rel_err(got, ref)
    finite = bool(got.isfinite().all())
    same = bool(torch.equal(got, again))
    ms = time_ms(torch, lambda: kern(*args))
    g_ms = graph_ms(torch, lambda: kern(*args))
    plain_ms = time_ms(torch, lambda: plain(*args))
    sc = scales if scales else (None, None)

    def gather():
        return pa.paged_kv_plain(*pools, *sc, tables, lens, layer, q.dtype)

    gather_ms = time_ms(torch, gather)
    kl, vl = gather()
    pos = (lens.long() - T)[:, None] + torch.arange(T, device="cuda")
    key = torch.arange(kl.shape[2], device="cuda")
    mask = ((key[None, None, :] <= pos[:, :, None])
            & (key[None, None, :] < lens.long()[:, None, None]))[:, None]
    sdpa = _sdpa(torch, q.transpose(1, 2), kl, vl, mask=mask)
    sdpa_ms = time_ms(torch, sdpa)
    sdpa_g_ms = graph_ms(torch, sdpa)
    del kl, vl
    n_bytes = _pool_bytes(pools, scales, sum(lens_list), Hk, D) \
        + 2 * (2 * B * T * Hq * D) + 4 * B + 4 * tables.numel()
    n_ops = 4 * Hq * D * sum(n - T + t + 1 for n in lens_list
                             for t in range(T))
    b_ms, b_by = bound(n_bytes, n_ops, "bf16")
    groups = pa.paged_row_groups(T, Hq // Hk)
    plan = (*pa.plan_paged_split(B, Hk, groups, tables.shape[1] * PAGE),
            groups)
    tol = PAGED_TOL
    print(f"  {name} T={T} lens {lens_list} page {PAGE} x "
          f"{tables.shape[1]} pages: err {err:.3g}, relative {rel:.3g} (tol "
          f"{tol:.3g} of each vector's max), two calls bit-identical {same} "
          f"| plan (span, splits, row_groups) {plan} | kernel {ms:.4f} ms | "
          f"in a CUDA graph {g_ms:.4f} | plain {plain_ms:.4f} | sdpa "
          f"{sdpa_ms:.4f} (graph {sdpa_g_ms:.4f}) + gather {gather_ms:.4f} "
          f"| bound {b_ms:.5f} ({b_by})", flush=True)
    if not rel <= tol or not finite or not same:
        fail(f"{name} T={T} relative err {rel} > {tol}, non-finite "
             f"({finite}) or two calls differ ({same})")
    return dict(shape=f"B={B} T={T} lens={lens_list} page={PAGE} "
                      f"max_pages={tables.shape[1]} Hq={Hq} Hk={Hk}",
                max_abs_err=err, rel_err=rel, tol=tol, ms=ms, graph_ms=g_ms,
                plain_ms=plain_ms, library_ms=sdpa_ms,
                library_graph_ms=sdpa_g_ms, gather_ms=gather_ms,
                bound_ms=b_ms, bound_by=b_by, plan=plan)


def verify_lens(T):
    """8 slots' lengths for a verify of T tokens: a window at the start of
    a sequence, rows inside one page, a window straddling pages 0 and 1
    (515), one starting at row 0 of page 1 (512 + T), long rows."""
    return [T, 37, 300, 515, 512 + T, 1100, 1027, 1440]


def check_paged_q8_and_verify(torch, cfg):
    """_paged_bhgd_q8 (decode at PAGED_LENS; verify at T = 5, 16 and 17:
    one row group of 35 rows, two of 112 and 119) and the bf16 verify shape
    of _paged_bhgd (T = 5, 16 and 17), 8 slots, pages of 512, NaN in the
    pages no table holds and past each row's length (NaN scales for int8).
    The JSON line keeps T = 5, the serving verify's shape, with T = 16 and
    17 under at_T16 / at_T17."""
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    Hq, D = cfg.num_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(10)
    k0, v0, tables = _paged_pool(torch, cfg, g)
    B = len(PAGED_LENS)
    recs = {}
    k, v = k0.clone(), v0.clone()
    _stale(torch, k, v, tables, PAGED_LENS)
    k8, v8, ks, vs = _q8_pool(torch, k, v)
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    recs["paged_decode_attention_stacked_q8"] = paged_attention_case(
        torch, "paged_decode_attention_stacked_q8",
        pa.paged_decode_attention_stacked_q8,
        pa.paged_decode_attention_q8_plain, q, (k8, v8), (ks, vs), tables,
        PAGED_LENS)
    by_t = {}
    for T in (17, 16, 5):
        lens = verify_lens(T)
        k, v = k0.clone(), v0.clone()
        _stale(torch, k, v, tables, lens)
        k8, v8, ks, vs = _q8_pool(torch, k, v)
        q = torch.randn((B, T, Hq, D), generator=g,
                        device="cuda").to(torch.bfloat16)
        by_t[T] = {
            "paged_verify_attention_stacked": paged_attention_case(
                torch, "paged_verify_attention_stacked",
                pa.paged_verify_attention_stacked,
                pa.paged_decode_attention_plain, q, (k, v), (), tables,
                lens),
            "paged_verify_attention_stacked_q8": paged_attention_case(
                torch, "paged_verify_attention_stacked_q8",
                pa.paged_verify_attention_stacked_q8,
                pa.paged_decode_attention_q8_plain, q, (k8, v8), (ks, vs),
                tables, lens)}
    for name in by_t[5]:
        recs[name] = dict(by_t[5][name], at_T16=by_t[16][name],
                          at_T17=by_t[17][name])
    return recs


def _paged_chunk_identity(torch, kern, contiguous, q, pools, scales, tables,
                          layer, start):
    """The paged chunk kernel over row 0's pages against the contiguous
    chunk kernel over the same rows laid out as a cache [L, 1, Hk, S, D]
    (and scales [L, 1, Hk, S]): through the row's own (shuffled) table and
    through identity tables over the pages copied in order, both must give
    the contiguous kernel's bits (one block a 64-row tile, no key split:
    the same arithmetic).  Returns whether both did."""
    rows = [t[:, tables[0].long()].contiguous() for t in pools + scales]
    L, n, Hk, page = rows[0].shape[:4]
    cache = [r.transpose(1, 2).reshape(L, 1, Hk, n * page, *r.shape[4:])
             for r in rows]
    want = contiguous(q, *cache, layer, start)
    ident = torch.arange(n, dtype=torch.int32, device="cuda")[None]
    same = [torch.equal(kern(q, *pools, *scales, tables, layer, start, PAGE),
                        want),
            torch.equal(kern(q, *rows, ident, layer, start, PAGE), want)]
    return all(same)


def check_paged_chunk(torch, cfg, cfg_moe, quant=False):
    """The serving continuation piece (paged_chunk_mma_kernel): B=1, T=256
    at starts 256, 1280, the mid-page 700, and (bf16) 2040, whose
    bucket-padded piece runs past the 4-page table (its rows there attend
    the whole table), over pages of 512, Qwen2.5-7B's heads (Hq 28, Hk 4)
    and, at 700 and 1280, Qwen3-30B-A3B's (Hq 32, Hk 4: G 8); NaN past
    each piece's end in its pages (NaN scales for int8).  Each a call and
    in a CUDA graph, beside SDPA over a gathered copy (a call and in a
    graph) and the gather; at every in-table start the kernel's bits
    through the row's table and through identity tables must be
    chunk_attention_contiguous(_q8)'s over the same rows."""
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    Hk, D = cfg.num_kv_heads, cfg.head_dim
    assert (cfg_moe.num_kv_heads, cfg_moe.head_dim) == (Hk, D)
    g = torch.Generator(device="cuda").manual_seed(8 + quant)
    k0, v0, tables = _paged_pool(torch, cfg, g, rows=1)
    width = tables.shape[1] * PAGE
    T, layer, tol = 256, 1, PAGED_TOL
    name = "paged_chunk_attention_q8" if quant else "paged_chunk_attention"
    kern = getattr(ca, name)
    plain = getattr(ca, name + "_plain")
    contiguous = getattr(ca, "chunk_attention_contiguous"
                         + ("_q8" if quant else ""))
    qs = {c.name: torch.randn((1, T, c.num_heads, D), generator=g,
                              device="cuda").to(torch.bfloat16)
          for c in (cfg, cfg_moe)}
    starts = [(cfg, s) for s in ((256, 700, 1280) if quant
                                 else (256, 700, 2040, 1280))]
    starts += [(cfg_moe, 700), (cfg_moe, 1280)]
    rec = None
    for c, start in starts:
        q = qs[c.name]
        Hq = c.num_heads
        end = min(start + T, width)
        k, v = k0.clone(), v0.clone()
        _stale(torch, k, v, tables, [end])
        pools, scales = (k, v), ()
        if quant:
            k8, v8, ks, vs = _q8_pool(torch, k, v)
            pools, scales = (k8, v8), (ks, vs)
        args = (q, *pools, *scales, tables, layer, start, PAGE)
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        rel = rel_err(got, ref)
        finite = bool(got.isfinite().all())
        bits = None
        if start + T <= width:
            bits = _paged_chunk_identity(torch, kern, contiguous, q, pools,
                                         scales, tables, layer, start)
        ms = time_ms(torch, lambda: kern(*args))
        g_ms = graph_ms(torch, lambda: kern(*args))
        plain_ms = time_ms(torch, lambda: plain(*args), iters=3, warmup=1)
        n = torch.tensor([end], device="cuda")
        sc = scales if quant else (None, None)

        def gather():
            return pa.paged_kv_plain(*pools, *sc, tables, n, layer, q.dtype)

        gather_ms = time_ms(torch, gather)
        kl, vl = gather()
        kl, vl = kl[:, :, :end], vl[:, :, :end]
        qpos = start + torch.arange(T, device="cuda")
        mask = torch.arange(end, device="cuda")[None, :] <= qpos[:, None]
        sdpa = _sdpa(torch, q.transpose(1, 2), kl, vl, mask=mask)
        sdpa_ms = time_ms(torch, sdpa)
        sdpa_g_ms = graph_ms(torch, sdpa)
        del kl, vl
        n_bytes = _pool_bytes(pools, scales, end, Hk, D) \
            + 2 * 2 * T * Hq * D + 4 * tables.numel()
        n_ops = 4 * Hq * D * sum(min(start + t + 1, width) for t in range(T))
        b_ms, b_by = bound(n_bytes, n_ops, "bf16")
        print(f"  {name} {c.name} T={T} start {start} page {PAGE}: err "
              f"{err:.3g}, relative {rel:.3g} (tol {tol:.3g} of each vector's "
              f"max) | bit-equal to {contiguous.__name__} through its table "
              f"and identity tables {bits} | kernel {ms:.4f} ms | in a CUDA "
              f"graph {g_ms:.4f} ({n_ops / g_ms / 1e9:.1f} TFLOP/s) | plain "
              f"{plain_ms:.4f} | sdpa {sdpa_ms:.4f} (graph {sdpa_g_ms:.4f}) "
              f"+ gather {gather_ms:.4f} | bound {b_ms:.5f} ({b_by})",
              flush=True)
        if not rel <= tol or not finite or bits is False:
            fail(f"{name} {c.name} start {start} relative err {rel} > {tol}, "
                 f"non-finite ({finite}) or not {contiguous.__name__}'s bits "
                 f"({bits})")
        r = dict(shape=f"B=1 T={T} start={start} page={PAGE} Hq={Hq} "
                       f"Hk={Hk} D={D}", kernel="paged_chunk_mma_kernel",
                 max_abs_err=err, rel_err=rel, tol=tol, ms=ms, graph_ms=g_ms,
                 plain_ms=plain_ms, library_ms=sdpa_ms,
                 library_graph_ms=sdpa_g_ms, gather_ms=gather_ms,
                 bound_ms=b_ms, bound_by=b_by, identity_bit_equal=bits)
        if c is cfg_moe:
            rec[f"at_30b_a3b_start_{start}"] = r
        elif start == 1280:   # the JSON line's main numbers
            rec = dict(r, **(rec or {}))
        else:
            rec = dict(rec or {}, **{f"at_start_{start}": r})
    return {name: rec}


SPEC_T = 5           # the serving verify window: spec_k = 4 drafts + 1
VERIFY_STARTS = [0, 36, 299, 508, 512, -1, 1099, 1435]


def check_paged_appends(torch, cfg):
    """The three paged appends, bit-exact, into a bf16 and an int8 pool
    (bytes and scales): the decode step's 8 rows at the positions before
    PAGED_LENS; a 256-token piece at start 384 (it crosses from page 0 to
    page 1 of its table); the verify window of SPEC_T tokens at
    VERIFY_STARTS (508 straddles pages 0 and 1, 512 starts page 1, -1 is
    skipped), and a window of 17 there (wider than 16).  Each a call and
    in a CUDA graph, beside index_put_ in a graph.  The JSON line keeps
    the bf16 times, the int8 ones beside, the T = 17 window as at_T17."""
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka

    Hk, D = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(9)
    k, v, tables = _paged_pool(torch, cfg, g)
    k, v = k.nan_to_num(), v.nan_to_num()
    k8, v8, ks, vs = _q8_pool(torch, k, v)
    layer = 1
    B = len(PAGED_LENS)
    pos = torch.tensor(PAGED_LENS, device="cuda", dtype=torch.int32) - 1
    starts = torch.tensor(VERIFY_STARTS, device="cuda", dtype=torch.int32)
    T, start = 256, 384

    def rows(shape):
        """bf16 rows and their int8 quantization (bytes, scales)."""
        from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        return (x, *quantize_kv(x))

    keep = torch.nonzero(starts >= 0)[:, 0]

    def window(n):
        """(page-table row, position) of every token of an n-token window
        at VERIFY_STARTS."""
        return (keep.repeat_interleave(n),
                (starts.long()[keep][:, None]
                 + torch.arange(n, device="cuda")).reshape(-1))

    # case: (wrapper, new rows' shape, where, (table row, position) of
    # every token it writes, the rows of k_new it writes, shape)
    cases = {
        "paged_append_ragged": (
            "paged_append_ragged", (B, 1), (pos, tables),
            (torch.arange(B, device="cuda"), pos.long()), slice(None),
            f"B={B} positions={[n - 1 for n in PAGED_LENS]}"),
        "paged_append_prefill": (
            "paged_append_prefill", (1, T), (start, tables[:1]),
            (torch.zeros(T, dtype=torch.long, device="cuda"),
             start + torch.arange(T, device="cuda")), slice(None),
            f"T={T} start={start}"),
        "paged_append_ragged_t": (
            "paged_append_ragged_t", (B, SPEC_T), (starts, tables),
            window(SPEC_T), keep, f"B={B} T={SPEC_T} starts={VERIFY_STARTS}"),
        "paged_append_ragged_t T17": (
            "paged_append_ragged_t", (B, 17), (starts, tables), window(17),
            keep, f"B={B} T=17 starts={VERIFY_STARTS}")}
    heads = torch.arange(Hk, device="cuda")[None, :]
    out = {}
    for case, (name, shape, (at, tab), (b_idx, p_idx), sel,
               desc) in cases.items():
        kern, plain = getattr(ka, name), getattr(ka, name + "_plain")
        (kb, kq, ksn), (vb, vq, vsn) = (rows((*shape, Hk, D)),
                                         rows((*shape, Hk, D)))
        ids = tab.long()[b_idx, p_idx // PAGE][:, None]
        lib_rows = (ids, heads, (p_idx % PAGE)[:, None])
        rec = None
        for quant in (False, True):
            base = (k8, v8, ks, vs) if quant else (k, v)
            nk, nv = (kq, vq) if quant else (kb, vb)
            extra = dict(ks_new=ksn, vs_new=vsn) if quant else {}

            def call(fn, st):
                kw = dict(extra, k_scale=st[2], v_scale=st[3]) if quant else {}
                return fn(st[0], st[1], nk, nv, at, tab, layer,
                          page_size=PAGE, **kw)

            mine = [t.clone() for t in base]
            theirs = [t.clone() for t in base]
            got = call(kern, mine)
            call(plain, theirs)
            torch.cuda.synchronize()
            if got[0] is not mine[0] or got[1] is not mine[1]:
                fail(f"{name} did not return the pools it wrote")
            diff = sum(int((a != b).sum()) for a, b in zip(mine, theirs))
            written = int((mine[0] != base[0]).any(dim=-1).sum())
            n_tok = int(b_idx.numel())
            ms = time_ms(torch, lambda: call(kern, mine))
            g_ms = graph_ms(torch, lambda: call(kern, mine))
            plain_ms = time_ms(torch, lambda: call(plain, theirs))

            def lib():
                """The library yardstick: an index_put_ scatter of the same
                rows (indices [n, Hk] over the page, head and row axes)."""
                theirs[0][layer].index_put_(lib_rows,
                                            nk[sel].reshape(-1, Hk, D))
                theirs[1][layer].index_put_(lib_rows,
                                            nv[sel].reshape(-1, Hk, D))
                if quant:
                    theirs[2][layer].index_put_(lib_rows,
                                                ksn[sel].reshape(-1, Hk))
                    theirs[3][layer].index_put_(lib_rows,
                                                vsn[sel].reshape(-1, Hk))

            lib_ms = time_ms(torch, lib)
            lib_g_ms = graph_ms(torch, lib)
            elem = 1 if quant else 2
            n_bytes = 2 * 2 * n_tok * Hk * (D * elem + (4 if quant else 0))
            b_ms, b_by = bound(n_bytes, 0, "bf16")
            plan = ka.plan_paged_append(shape[0], shape[1], Hk, D, elem,
                                        True)
            kind = "int8" if quant else "bf16"
            print(f"  {name} {kind} {desc}: {diff} elements differ "
                  f"(must be 0, scales included; {written} K rows written) "
                  f"| plan (vec, threads, blocks) {plan} | kernel {ms:.4f} "
                  f"ms (graph {g_ms:.5f}) | plain {plain_ms:.4f} | "
                  f"index_put_ {lib_ms:.4f} (graph {lib_g_ms:.5f}) | bound "
                  f"{b_ms:.6f} ({b_by})", flush=True)
            if diff != 0 or written != n_tok * Hk:
                fail(f"{name} {kind} not bit-exact: {diff} elements differ, "
                     f"{written} rows written (want {n_tok * Hk})")
            if not quant:
                rec = dict(shape=desc, max_abs_err=0.0, tol=0.0, ms=ms,
                           graph_ms=g_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_graph_ms=lib_g_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           kernel=f"append_rows_kernel (paged rows), plan "
                                  f"{plan}")
            else:
                rec.update(int8_ms=ms, int8_graph_ms=g_ms,
                           int8_plain_ms=plain_ms, int8_library_ms=lib_ms,
                           int8_library_graph_ms=lib_g_ms,
                           int8_bound_ms=b_ms)
        if case == name:
            out[name] = dict(rec, **out.get(name, {}))
        else:
            out.setdefault(name, {})["at_T17"] = rec
    return out


# ----------------------------------------------------------------------
# the double-pumped decode: its kernels (phase 3), [pumped generate]
# (phase 4) and its logits rule (phase 5)
# ----------------------------------------------------------------------

PUMP_BATCH, PUMP_PROMPT, PUMP_SEQ = 192, 256, 512
PUMP_YARDSTICK_STEPS = 8


def _mlp_stack(torch, g, K, F, gs_gate, gs_down, L=2):
    """Random stacked pad-free INT4 gate / up / down weights and scales
    (layer 1 is used) and their bf16 dequantized layer-1 slabs."""
    from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, dequantize

    def q(*shape):
        return torch.randint(-128, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    w = (q(L, K // 2, F), torch.full((L, K // gs_gate, F), K ** -0.5 / 7,
                                     device="cuda"),
         q(L, K // 2, F), torch.full((L, K // gs_gate, F), K ** -0.5 / 7,
                                     device="cuda"),
         q(L, F // 2, K), torch.full((L, F // gs_down, K), F ** -0.5 / 7,
                                     device="cuda"))
    deq = [dequantize(QuantLinear(q=w[i][1], scales=w[i + 1][1], b=None,
                                  bits=4, group_size=gs))
           for i, gs in ((0, gs_gate), (2, gs_gate), (4, gs_down))]
    return w, deq


def _mlp_library(torch, x, deq):
    """The yardstick: bf16 ``torch.matmul`` x 3 + SiLU over the dequantized
    weights."""
    F_ = torch.nn.functional
    wg, wu, wd = deq
    return lambda: torch.matmul(F_.silu(torch.matmul(x, wg))
                                * torch.matmul(x, wu), wd)


def _mlp_bytes_ops(M, K, F, gs_gate, gs_down):
    """What one fused MLP must move and compute: x and y once, the three
    INT4 weights and their f32 scales once; 6 M K F operations."""
    n_bytes = (2 * M * K * 2 + 3 * (K // 2) * F
               + 4 * (2 * (K // gs_gate) * F + (F // gs_down) * K))
    return n_bytes, 6 * M * K * F


def check_fused_mlp(torch, cfg):
    """fused_mlp against its plain version at the Qwen2.5-7B MLP (K 3584,
    F 18944): the pumped weights' group sizes (gate / up 256, down 128:
    pad-free gs 256) at M = 4, 8, 40, 192 and 256, and run (a)'s gs 128 /
    128 at M = 4.  Tolerance 2^-6 of the largest output (the matmuls'
    rule: both round h and y to bf16, and the tensor cores' f32 sums of g
    and u differ from the plain version's in order).  Each shape prints
    its two plans; at M <= 64 also a call's device time in a CUDA graph
    beside the yardstick's."""
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs

    K, F = cfg.hidden_size, cfg.intermediate_size
    g = torch.Generator(device="cuda").manual_seed(21)
    records = []
    for gs_gate, gs_down, ms_list in ((256, 128, (4, 8, 40, 192, 256)),
                                      (128, 128, (4,))):
        w, deq = _mlp_stack(torch, g, K, F, gs_gate, gs_down)
        kw = dict(gs_gate=gs_gate, gs_down=gs_down)
        for M in ms_list:
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            got = fs.fused_mlp(x, *w, 1, **kw)
            again = fs.fused_mlp(x, *w, 1, **kw)
            ref = fs.fused_mlp_plain(x, *w, 1, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2 ** -6 * ref.float().abs().max().item()
            same = bool(torch.equal(got, again))
            ms = time_ms(torch, lambda: fs.fused_mlp(x, *w, 1, **kw))
            plain_ms = time_ms(torch, lambda: fs.fused_mlp_plain(x, *w, 1, **kw),
                               iters=3, warmup=1)
            lib_ms = time_ms(torch, _mlp_library(torch, x, deq))
            b_ms, b_by = bound(*_mlp_bytes_ops(M, K, F, gs_gate, gs_down),
                               "bf16")
            rec = dict(shape=f"{cfg.name} MLP M={M} K={K} F={F} gs "
                             f"{gs_gate}/{gs_down}", M=M, gs=(gs_gate, gs_down),
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       plan=fs.plan_fused_mlp(M, K, F, gs_gate, gs_down))
            extra = ""
            if M <= 64:  # decode: a call's device time apart from the host's
                rec["graph_ms"] = graph_ms(
                    torch, lambda: fs.fused_mlp(x, *w, 1, **kw))
                rec["library_graph_ms"] = graph_ms(
                    torch, _mlp_library(torch, x, deq))
                extra = (f" | in a CUDA graph: kernel {rec['graph_ms']:.4f}, "
                         f"torch.matmul x3 {rec['library_graph_ms']:.4f}")
            print(f"  fused_mlp {rec['shape']}: err {err:.3g} (tol {tol:.3g}),"
                  f" two calls bit-identical {same} | kernel {ms:.4f} ms | "
                  f"plain {plain_ms:.4f} | torch.matmul bf16 x3 + silu "
                  f"{lib_ms:.4f}{extra} | plans (gate/up, down) {rec['plan']}"
                  f" | bound {b_ms:.4f} ({b_by})", flush=True)
            if not err <= tol or not same:
                fail(f"fused_mlp {rec['shape']} err {err} > {tol} or two "
                     f"calls differ")
            records.append(rec)
        del w, deq
    return records


def check_fused_attn_mlp(torch, cfg):
    """fused_attn_mlp at the pumped decode's shapes: a half batch of 96
    rows of a 192-row cache (S 512, every row at length 257), Hk 4, G 7,
    D 128, row0 0 and 96, beside the pumped weights' MLP on Mb = 96 rows
    (the unsplit 64-row tiles), and from row 96 also beside Mb = 40 (the
    split decode stream's plan).  The attention within 2e-2 (the decode
    kernels' rule), the MLP within fused_mlp's; two calls bit-identical.
    Each case prints both MLP plans and a call's device time in a CUDA
    graph.  The yardstick is SDPA over the half's rows plus the bf16 MLP
    of _mlp_library."""
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs

    Ba, Bc, S, n = PUMP_BATCH // 2, PUMP_BATCH, PUMP_SEQ, PUMP_PROMPT + 1
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    K, F = cfg.hidden_size, cfg.intermediate_size
    g = torch.Generator(device="cuda").manual_seed(22)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    kc, vc = rnd(2, Bc, Hk, S, D), rnd(2, Bc, Hk, S, D)
    w, deq = _mlp_stack(torch, g, K, F, 256, 128)
    lens = torch.full((Ba,), n, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda") < n)[None, None, None, :]
    records = {}
    for row0, Mb in ((0, Ba), (Ba, Ba), (Ba, 40)):
        q, x = rnd(Ba, 1, Hq, D), rnd(Mb, K)
        kw = dict(gs_gate=256, gs_down=128, row0=row0)

        def call():
            return fs.fused_attn_mlp(lens, 1, 1, q, kc, vc, x, *w, **kw)

        attn, y = call()
        attn2, y2 = call()
        ra, ry = fs.fused_attn_mlp_plain(lens, 1, 1, q, kc, vc, x, *w, **kw)
        torch.cuda.synchronize()
        a_err = (attn.float() - ra.float()).abs().max().item()
        y_err = (y.float() - ry.float()).abs().max().item()
        y_tol = 2 ** -6 * ry.float().abs().max().item()
        same = bool(torch.equal(attn, attn2) and torch.equal(y, y2))
        ms = time_ms(torch, call)
        g_ms = graph_ms(torch, call)
        plain_ms = time_ms(torch, lambda: fs.fused_attn_mlp_plain(
            lens, 1, 1, q, kc, vc, x, *w, **kw), iters=3, warmup=1)
        sdpa = _sdpa(torch, q.transpose(1, 2), kc[1, row0:row0 + Ba],
                     vc[1, row0:row0 + Ba], mask=mask)
        mlp = _mlp_library(torch, x, deq)
        lib_ms = time_ms(torch, lambda: (sdpa(), mlp()))
        lib_g_ms = graph_ms(torch, lambda: (sdpa(), mlp()))
        mb, mo = _mlp_bytes_ops(Mb, K, F, 256, 128)
        n_bytes = mb + 2 * (2 * Ba * Hk * n * D) + 2 * (2 * Ba * Hq * D) + 4 * Ba
        b_ms, b_by = bound(n_bytes, mo + 4 * Ba * Hq * n * D, "bf16")
        plans = fs.plan_fused_mlp(Mb, K, F, 256, 128)
        rec = dict(shape=f"Ba={Ba} rows from {row0} of {Bc}, lens {n} S={S}"
                         f" Hq={Hq} Hk={Hk}, MLP Mb={Mb} K={K} F={F} gs "
                         f"256/128",
                   max_abs_err=max(a_err, y_err), attn_err=a_err, mlp_err=y_err,
                   tol=y_tol, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library_graph_ms=lib_g_ms,
                   bound_ms=b_ms, bound_by=b_by, plans=plans)
        print(f"  fused_attn_mlp row0 {row0} Mb {Mb}: attention err "
              f"{a_err:.3g} (tol 0.02), MLP err {y_err:.3g} (tol "
              f"{y_tol:.3g}), two calls bit-identical {same} | plans "
              f"(gate/up, down) {plans} | kernel {ms:.4f} ms | in a CUDA "
              f"graph {g_ms:.4f} | plain {plain_ms:.4f} | sdpa + "
              f"torch.matmul bf16 x3 + silu {lib_ms:.4f} (graph "
              f"{lib_g_ms:.4f}) | bound {b_ms:.4f} ({b_by})", flush=True)
        if not (a_err <= 2e-2 and y_err <= y_tol and same):
            fail(f"fused_attn_mlp row0 {row0} Mb {Mb}: attention err "
                 f"{a_err}, MLP err {y_err} (tol {y_tol}), bit-identical "
                 f"{same}")
        records[(row0, Mb)] = rec
    return records


def check_kv_append_uniform(torch, cfg):
    """kv_append_uniform at the pumped decode's second half: 96 rows from
    row 96 of a 192-row bf16 cache, position 257 of 512: bit-exact, and
    nothing else of the cache touched."""
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka

    L, Bc, S, pos, layer = 2, PUMP_BATCH, PUMP_SEQ, PUMP_PROMPT + 1, 1
    Bn = row0 = PUMP_BATCH // 2
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(23)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    kc, vc = rnd(L, Bc, Hk, S, D), rnd(L, Bc, Hk, S, D)
    kn, vn = rnd(Bn, 1, Hk, D), rnd(Bn, 1, Hk, D)
    mine = [kc.clone(), vc.clone()]
    theirs = [kc.clone(), vc.clone()]
    got = ka.kv_append_uniform(*mine, kn, vn, pos, layer, row0=row0)
    ref = ka.kv_append_uniform_plain(*theirs, kn, vn, pos, layer, row0)
    torch.cuda.synchronize()
    if any(a is not b for a, b in zip(got, mine)):
        fail("kv_append_uniform did not return the tensors it wrote")
    diff = sum(int((a != b).sum()) for a, b in zip(got, ref))
    touched = int(((mine[0] != kc).any(-1) | (mine[1] != vc).any(-1)).sum())
    pos_t = torch.tensor([pos], device="cuda", dtype=torch.int32)

    def kernel():
        ka.kv_append_uniform(*mine, kn, vn, pos_t, layer, row0=row0)

    ms = time_ms(torch, kernel)
    g_ms = graph_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: ka.kv_append_uniform_plain(
        *theirs, kn, vn, pos, layer, row0))

    def library():
        theirs[0][layer, row0:row0 + Bn, :, pos] = kn[:, 0]
        theirs[1][layer, row0:row0 + Bn, :, pos] = vn[:, 0]

    lib_ms = time_ms(torch, library)
    lib_g_ms = graph_ms(torch, library)
    b_ms, b_by = bound(2 * (2 * 2 * Bn * Hk * D), 0, "bf16")
    print(f"  kv_append_uniform rows {row0}..{row0 + Bn - 1} position {pos}: "
          f"{diff} elements differ (must be 0), {touched} (row, head) vectors "
          f"changed (at most {Bn * Hk}) | kernel {ms:.4f} ms | in a CUDA "
          f"graph {g_ms:.5f} | plain {plain_ms:.4f} | slice assignment "
          f"{lib_ms:.4f} (graph {lib_g_ms:.5f}) | bound {b_ms:.6f} "
          f"({b_by})", flush=True)
    if diff != 0 or not 0 < touched <= Bn * Hk:
        fail(f"kv_append_uniform not bit-exact: {diff} elements differ, "
             f"{touched} vectors changed")
    return dict(shape=f"Bn={Bn} rows from {row0} of {Bc}, position {pos} "
                      f"S={S} Hk={Hk} D={D}", max_abs_err=0.0, tol=0.0, ms=ms,
                graph_ms=g_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by)


# ----------------------------------------------------------------------
# the last four Pallas sites: the ragged window append (phase 3; the
# ragged and verify runs), the deferred-append decode's two kernels (phase
# 3; [deferred decode]; its phase-5 rule) and the fused attention + matmul
# (phase 3; [probe fused])
# ----------------------------------------------------------------------

RAGGED_S = 1024     # the ragged runs' cache (max_seq 1024)


def check_kv_append_ragged_t(torch, cfg):
    """kv_append_ragged_t at the ragged decode's (T = 1) and the verify's
    (T = 5) shapes: Qwen2.5-7B's Hk 4, D 128, 4 rows of a cache of S =
    1024, bf16 and int8 with its scales, layer 1 of 2.  Two sets of starts
    a shape: -1 (skipped) and the TPU kernel's band edges 7, 8 and 31; then
    32, S - T, 0 and, at T = 5, S - 2 (a window that crosses S: its last
    three tokens are dropped; 500 at T = 1).  Bit-exact against the plain
    version, nothing outside the windows touched.  The yardstick is one
    ``index_put_`` scatter of the same rows a tensor (the port's former
    write); the bound counts the tokens written.  Each shape a call and in
    a CUDA graph, beside the yardstick's graph, with the row kernel's
    plan; the record keeps T = 1 bf16, the others as rows_t<T>[_int8]_*."""
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

    L, B, S, layer = 2, 4, RAGGED_S, 1
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(31)
    rec = None
    for T in (1, 5):
        for quant in (False, True):
            for starts_l in ([-1, 7, 8, 31],
                             [32, S - T, S - 2 if T > 1 else 500, 0]):
                if quant:
                    (kc, ks), (vc, vs) = (_int8(torch, g, (L, B, Hk, S, D))
                                          for _ in range(2))
                    (kn, ksn), (vn, vsn) = (quantize_kv(torch.randn(
                        (B, T, Hk, D), generator=g, device="cuda"))
                        for _ in range(2))
                    caches, news = (kc, vc, ks, vs), (kn, vn, ksn, vsn)
                else:
                    caches = tuple(torch.randn((L, B, Hk, S, D), generator=g,
                                               device="cuda").to(torch.bfloat16)
                                   for _ in range(2))
                    news = tuple(torch.randn((B, T, Hk, D), generator=g,
                                             device="cuda").to(torch.bfloat16)
                                 for _ in range(2))
                starts = torch.tensor(starts_l, device="cuda",
                                      dtype=torch.int32)

                def call(fn, cs, starts=starts, news=news):
                    kw = {} if len(cs) == 2 else dict(
                        k_scale=cs[2], v_scale=cs[3], ks_new=news[2],
                        vs_new=news[3])
                    return fn(cs[0], cs[1], news[0], news[1], starts, layer,
                              **kw)

                mine = [c.clone() for c in caches]
                theirs = [c.clone() for c in caches]
                call(ka.kv_append_ragged_t, mine)
                call(ka.kv_append_ragged_t_plain, theirs)
                torch.cuda.synchronize()
                diff = sum(int((a != b).sum()) for a, b in zip(mine, theirs))
                written = torch.zeros((L, B, Hk, S), dtype=torch.bool,
                                      device="cuda")
                rows, pos = [], []
                for b, p in enumerate(starts_l):
                    if p >= 0:
                        written[layer, b, :, p:min(p + T, S)] = True
                        n = min(T, S - p)
                        rows += [b] * n
                        pos += list(range(p, p + n))
                stray = int(((mine[0] != caches[0]).any(-1)
                             & ~written).sum())
                n_tok = len(pos)
                label = (f"kv_append_ragged_t T={T} "
                         f"{'int8' if quant else 'bf16'} starts {starts_l}")
                if diff != 0 or stray != 0:
                    fail(f"{label}: {diff} elements differ from the plain "
                         f"version, {stray} vectors outside the windows "
                         f"changed")
            # timed at the second set of starts
            ms = time_ms(torch, lambda: call(ka.kv_append_ragged_t, mine))
            plain_ms = time_ms(torch, lambda: call(ka.kv_append_ragged_t_plain,
                                                   theirs))
            ri = torch.tensor(rows, device="cuda")
            pi = torch.tensor(pos, device="cuda")
            src = [(b, t) for b, p in enumerate(starts_l) if p >= 0
                   for t in range(min(T, S - p))]
            bi = torch.tensor([b for b, _ in src], device="cuda")
            ti = torch.tensor([t for _, t in src], device="cuda")

            def library():
                for c, n in zip(theirs, news):
                    c[layer, ri, :, pi] = n[bi, ti]

            g_ms = graph_ms(torch, lambda: call(ka.kv_append_ragged_t, mine))
            lib_ms = time_ms(torch, library)
            lib_g_ms = graph_ms(torch, library)
            elem = 1 if quant else 2
            n_bytes = 2 * 2 * n_tok * Hk * D * elem + \
                (2 * 2 * n_tok * Hk * 4 if quant else 0) + 4 * B
            b_ms, b_by = bound(n_bytes, 0, "bf16")
            plan = ka.plan_paged_append(B, T, Hk, D, elem, True)
            print(f"  {label}: bit-exact, nothing else touched | plan (vec, "
                  f"threads, blocks) {plan} | kernel {ms:.4f} ms (graph "
                  f"{g_ms:.5f}) | plain {plain_ms:.4f} | index_put_ "
                  f"{lib_ms:.4f} (graph {lib_g_ms:.5f}) | bound {b_ms:.6f} "
                  f"({b_by})", flush=True)
            if T == 1 and not quant:
                rec = dict(shape=f"B={B} T=1 S={S} Hk={Hk} D={D} bf16 (the "
                                 f"ragged decode's write)", max_abs_err=0.0,
                           tol=0.0, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_graph_ms=lib_g_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           kernel=f"append_rows_kernel (contiguous rows), "
                                  f"plan {plan}")
            else:
                key = f"rows_t{T}" + ("_int8" if quant else "")
                rec.update({f"{key}_ms": ms, f"{key}_graph_ms": g_ms,
                            f"{key}_plain_ms": plain_ms,
                            f"{key}_library_ms": lib_ms,
                            f"{key}_library_graph_ms": lib_g_ms,
                            f"{key}_bound_ms": b_ms})
    return rec


DEFERRED_SHAPES = ((4, RAGGED_S), (PUMP_BATCH, PUMP_SEQ))


def check_deferred_kernels(torch, cfg):
    """The deferred-append decode's kernels at Qwen2.5-7B's shapes (Hq 28,
    Hk 4, D 128): ``decode_attention_contiguous_fresh`` at B = 4 (S 1024)
    and B = 192 (S 512, the [deferred decode] batch), layer 1 of 2, old
    lengths random with rows at 0 and S - 1, and 1e4 in every cache
    position at or past a row's old length (a read of one would show):
    within 2e-2 of the plain version (the decode kernels' rule); yardstick
    SDPA over the cache with the fresh row written first.
    ``kv_append_all_uniform`` at 28 layers: B = 4 at position S - 1 of
    1024, B = 192 at position 257 of 512 (the [deferred decode] step's):
    bit-exact, only the rows at the position touched; yardstick a slice
    assignment."""
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka

    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(32)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    fresh, append = None, None
    for B, S in DEFERRED_SHAPES:
        L, layer = 2, 1
        kc, vc = rnd(L, B, Hk, S, D), rnd(L, B, Hk, S, D)
        old = torch.randint(1, S - 1, (B,), generator=g, device="cuda")
        old[0], old[-1] = 0, S - 1
        far = torch.arange(S, device="cuda")[None, :] >= old[:, None]
        for c in (kc, vc):
            c.masked_fill_(far[None, :, None, :, None], 1e4)
        q, kn, vn = rnd(B, 1, Hq, D), rnd(B, 1, Hk, D), rnd(B, 1, Hk, D)
        old32 = old.to(torch.int32)
        got = da.decode_attention_contiguous_fresh(q, kc, vc, kn, vn, layer,
                                                   old32)
        ref = da.decode_attention_contiguous_fresh_plain(q, kc, vc, kn, vn,
                                                         layer, old32)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ms = time_ms(torch, lambda: da.decode_attention_contiguous_fresh(
            q, kc, vc, kn, vn, layer, old32))
        g_ms = graph_ms(torch, lambda: da.decode_attention_contiguous_fresh(
            q, kc, vc, kn, vn, layer, old32))
        plain_ms = time_ms(torch, lambda: da.decode_attention_contiguous_fresh_plain(
            q, kc, vc, kn, vn, layer, old32), iters=3, warmup=1)
        rows = torch.arange(B, device="cuda")
        kw, vw = kc[layer].clone(), vc[layer].clone()
        kw[rows, :, old] = kn[:, 0]
        vw[rows, :, old] = vn[:, 0]
        mask = (torch.arange(S, device="cuda")[None, :] <= old[:, None])
        sdpa = _sdpa(torch, q.transpose(1, 2), kw, vw,
                     mask=mask[:, None, None, :])
        lib_ms = time_ms(torch, sdpa)
        lib_g_ms = graph_ms(torch, sdpa)
        del kw, vw, sdpa
        n_keys = int(old.sum())
        n_bytes = (2 * (2 * n_keys * Hk * D) + 2 * (2 * B * Hq * D)
                   + 2 * (2 * B * Hk * D) + 4 * B)
        b_ms, b_by = bound(n_bytes, 4 * (n_keys + B) * Hq * D, "bf16")
        tol = 2e-2
        plan = da.plan_decode_split(B, Hk, S)
        print(f"  decode_attention_contiguous_fresh B={B} S={S} old lengths "
              f"0..{S - 1} (1e4 at and past each): err {err:.3g} (tol {tol})"
              f" | plan (span, splits) {plan} | kernel {ms:.4f} ms | in a "
              f"CUDA graph {g_ms:.4f} | plain {plain_ms:.4f} | sdpa (row "
              f"written first) {lib_ms:.4f} (graph {lib_g_ms:.4f}) | bound "
              f"{b_ms:.5f} ({b_by})", flush=True)
        if not err <= tol or not bool(got.isfinite().all()):
            fail(f"decode_attention_contiguous_fresh B={B}: err {err} > {tol}")
        r = dict(tol=tol, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                 library_ms=lib_ms, library_graph_ms=lib_g_ms, bound_ms=b_ms,
                 bound_by=b_by)
        if fresh is None:
            fresh = {f"rows_b{B}_{k}": v for k, v in r.items()
                     if k.endswith("ms")}
            fresh["max_abs_err"] = err
        else:
            fresh.update(shape=f"B={B} S={S} Hq={Hq} Hk={Hk} (the [deferred "
                               f"decode] batch), old lengths 0..{S - 1}",
                         max_abs_err=max(err, fresh["max_abs_err"]), **r)
        del kc, vc

        L = cfg.num_layers
        pos = S - 1 if B == 4 else PUMP_PROMPT + 1
        kc, vc = rnd(L, B, Hk, S, D), rnd(L, B, Hk, S, D)
        kn, vn = rnd(L, B, 1, Hk, D), rnd(L, B, 1, Hk, D)
        mine, theirs = [kc.clone(), vc.clone()], [kc.clone(), vc.clone()]
        pos_t = torch.tensor([pos], device="cuda", dtype=torch.int32)
        ka.kv_append_all_uniform(*mine, kn, vn, pos_t)
        ka.kv_append_all_uniform_plain(*theirs, kn, vn, pos)
        torch.cuda.synchronize()
        diff = sum(int((a != b).sum()) for a, b in zip(mine, theirs))
        changed = ((mine[0] != kc).any(-1) | (mine[1] != vc).any(-1))
        stray = int(changed.sum() - changed[:, :, :, pos].sum())
        del kc, vc
        def kernel():
            ka.kv_append_all_uniform(*mine, kn, vn, pos_t)

        ms = time_ms(torch, kernel)
        g_ms = graph_ms(torch, kernel)
        plain_ms = time_ms(torch, lambda: ka.kv_append_all_uniform_plain(
            *theirs, kn, vn, pos))

        def library():
            theirs[0][:, :, :, pos] = kn[:, :, 0]
            theirs[1][:, :, :, pos] = vn[:, :, 0]

        lib_ms = time_ms(torch, library)
        lib_g_ms = graph_ms(torch, library)
        b_ms, b_by = bound(2 * 2 * (2 * L * B * Hk * D) + 4, 0, "bf16")
        print(f"  kv_append_all_uniform L={L} B={B} position {pos} of {S}: "
              f"{diff} elements differ (must be 0), {stray} vectors changed "
              f"off the position | kernel {ms:.4f} ms | in a CUDA graph "
              f"{g_ms:.5f} | plain {plain_ms:.4f} | slice assignment "
              f"{lib_ms:.4f} (graph {lib_g_ms:.5f}) | bound {b_ms:.6f} "
              f"({b_by})", flush=True)
        if diff != 0 or stray != 0:
            fail(f"kv_append_all_uniform B={B}: {diff} elements differ, "
                 f"{stray} vectors changed off the position")
        r = dict(max_abs_err=0.0, tol=0.0, ms=ms, graph_ms=g_ms,
                 plain_ms=plain_ms, library_ms=lib_ms,
                 library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by)
        if append is None:
            append = {f"rows_b{B}_{k}": v for k, v in r.items()
                      if k.endswith("ms")}
        else:
            append.update(shape=f"L={L} B={B} position {pos} S={S} Hk={Hk} "
                                f"D={D} (the [deferred decode] step's)", **r)
        del mine, theirs
        torch.cuda.empty_cache()
    return {"decode_attention_contiguous_fresh": fresh,
            "kv_append_all_uniform": append}


PROBE = dict(L=2, B=112, S=1024, Ba=56, Mb=56, gs=256)


def _probe_operands(torch, cfg):
    """scripts/probe_fused.py's operands: a bf16 cache of 112 rows (Hk 4,
    S 1024, D 128) at 2 layers, lens S - 7 for Ba = 56 rows, q for them,
    x [56, 3584] and the 7B gate projection's INT4 stack (K 3584, N 18944,
    gs 256) with scales, drawn from a seeded generator."""
    p = PROBE
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    K, N = cfg.hidden_size, cfg.intermediate_size
    g = torch.Generator(device="cuda").manual_seed(33)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    kc, vc = rnd(p["L"], p["B"], Hk, p["S"], D), rnd(p["L"], p["B"], Hk,
                                                    p["S"], D)
    wq = torch.randint(-128, 128, (p["L"], K // 2, N), generator=g,
                       device="cuda", dtype=torch.int8)
    ws = torch.rand((p["L"], K // p["gs"], N), generator=g,
                    device="cuda") * 0.001 + 0.001
    lens = torch.full((p["Ba"],), p["S"] - 7, device="cuda", dtype=torch.int32)
    return dict(kc=kc, vc=vc, wq=wq, ws=ws, lens=lens,
                q=rnd(p["Ba"], 1, Hq, D), x=rnd(p["Mb"], K))


def check_fused_attn_matmul(torch, cfg):
    """fused_attn_matmul at scripts/probe_fused.py's shapes (``PROBE``) at
    layer 1, row0 0 and 56: the attention within 2e-2 of the plain version
    (the decode kernels' rule), y within 2^-6 of its largest value (the
    W4A16 rule); two calls bit-identical; y bit-equal to quant_matmul4's
    (the same body, plan and reduce at Mb <= 64) and the attention to
    fused_attn_mlp's for the same rows (the same attention blocks).  Each
    case prints the plan and a call's device time, alone and in a CUDA
    graph.  Yardstick: SDPA over the rows plus bf16 ``torch.matmul`` over
    the dequantized weight slab."""
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, dequantize

    p = PROBE
    o = _probe_operands(torch, cfg)
    Ba, S, gs = p["Ba"], p["S"], p["gs"]
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    K, N = cfg.hidden_size, cfg.intermediate_size
    n = S - 7
    deq = dequantize(QuantLinear(q=o["wq"][1], scales=o["ws"][1], b=None,
                                 bits=4, group_size=gs))
    # a narrow MLP beside the same attention blocks in fused_attn_mlp
    mlp, _ = _mlp_stack(torch, torch.Generator(device="cuda").manual_seed(34),
                        K, 512, 256, 128)
    mask = (torch.arange(S, device="cuda") < n)[None, None, None, :]
    args = (o["lens"], 1, o["q"], o["kc"], o["vc"], o["x"], o["wq"], o["ws"])
    plan = fs.plan_fused_attn_matmul(p["Mb"], K, N, gs)
    records = {}
    for row0 in (0, Ba):
        def call():
            return fs.fused_attn_matmul(*args, group_size=gs, row0=row0)

        attn, y = call()
        attn2, y2 = call()
        ra, ry = fs.fused_attn_matmul_plain(*args, group_size=gs, row0=row0)
        dense = qm.quant_matmul4(o["x"], o["wq"], o["ws"], 1, gs)
        attn_mlp, _ = fs.fused_attn_mlp(o["lens"], 1, 1, o["q"], o["kc"],
                                        o["vc"], o["x"], *mlp, gs_gate=256,
                                        gs_down=128, row0=row0)
        torch.cuda.synchronize()
        a_err = (attn.float() - ra.float()).abs().max().item()
        y_err = (y.float() - ry.float()).abs().max().item()
        y_tol = 2 ** -6 * ry.float().abs().max().item()
        same = bool(torch.equal(attn, attn2) and torch.equal(y, y2))
        y_dense = bool(torch.equal(y, dense))
        a_mlp = bool(torch.equal(attn, attn_mlp))
        del dense, attn_mlp
        ms = time_ms(torch, call)
        g_ms = graph_ms(torch, call)
        plain_ms = time_ms(torch, lambda: fs.fused_attn_matmul_plain(
            *args, group_size=gs, row0=row0), iters=3, warmup=1)
        sdpa = _sdpa(torch, o["q"].transpose(1, 2),
                     o["kc"][1, row0:row0 + Ba], o["vc"][1, row0:row0 + Ba],
                     mask=mask)

        def library():
            return sdpa(), torch.matmul(o["x"], deq)

        lib_ms = time_ms(torch, library)
        lib_g_ms = graph_ms(torch, library)
        n_bytes = (2 * (2 * Ba * Hk * n * D) + 2 * (2 * Ba * Hq * D) + 4 * Ba
                   + (K // 2) * N + 4 * (K // gs) * N + 2 * p["Mb"] * (K + N))
        b_ms, b_by = bound(n_bytes, 4 * Ba * Hq * n * D + 2 * p["Mb"] * K * N,
                           "bf16")
        rec = dict(shape=f"Ba=Mb={Ba} rows from {row0} of {p['B']}, lens {n} "
                         f"S={S} Hq={Hq} Hk={Hk}, INT4 K={K} N={N} gs {gs}",
                   max_abs_err=max(a_err, y_err), attn_err=a_err,
                   mm_err=y_err, tol=y_tol, ms=ms, graph_ms=g_ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_graph_ms=lib_g_ms, bound_ms=b_ms, bound_by=b_by,
                   plan=plan, y_equals_quant_matmul4=y_dense,
                   attn_equals_fused_attn_mlp=a_mlp)
        print(f"  fused_attn_matmul row0 {row0}: attention err {a_err:.3g} "
              f"(tol 0.02), matmul err {y_err:.3g} (tol {y_tol:.3g}), two "
              f"calls bit-identical {same}, y bit-equal to quant_matmul4 "
              f"{y_dense}, attention bit-equal to fused_attn_mlp's {a_mlp} "
              f"| plan (mt, splits, slice) {plan} | kernel {ms:.4f} ms | in "
              f"a CUDA graph {g_ms:.4f} | plain {plain_ms:.4f} | sdpa + "
              f"torch.matmul bf16 {lib_ms:.4f} (graph {lib_g_ms:.4f}) | "
              f"bound {b_ms:.4f} ({b_by})", flush=True)
        if not (a_err <= 2e-2 and y_err <= y_tol and same and y_dense
                and a_mlp):
            fail(f"fused_attn_matmul row0 {row0}: attention err {a_err}, "
                 f"matmul err {y_err} (tol {y_tol}), bit-identical {same}, "
                 f"y = quant_matmul4's {y_dense}, attention = "
                 f"fused_attn_mlp's {a_mlp}")
        records[row0] = rec
    return records


def run_probe_fused(torch, cfg, wrappers):
    """[probe fused], the port of scripts/probe_fused.py at its shapes
    (``PROBE``): t_attn, the decode attention alone on a Ba-row cache;
    t_mm, the W4A16 matmul alone (``quant_matmul4``, the gate projection);
    t_fused, one ``fused_attn_matmul`` doing both (row0 0).  Full overlap
    would give t_fused = max(t_attn, t_mm), none their sum.  Each a call
    and in a CUDA graph (the host's launch cost out of the way).  Returns
    the run's launch counts and numbers."""
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm

    p = PROBE
    o = _probe_operands(torch, cfg)
    Ba, gs = p["Ba"], p["gs"]
    kc_a = o["kc"][:, :Ba].contiguous()
    vc_a = o["vc"][:, :Ba].contiguous()
    for w in wrappers.values():
        w.launches = 0
    ops = {"attn": lambda: da.decode_attention_contiguous(
               o["q"], kc_a, vc_a, 1, o["lens"]),
           "mm": lambda: qm.quant_matmul4(o["x"], o["wq"], o["ws"], 1, gs),
           "fused": lambda: fs.fused_attn_matmul(
               o["lens"], 1, o["q"], o["kc"], o["vc"], o["x"], o["wq"],
               o["ws"], group_size=gs, row0=0)}
    t = {k: time_ms(torch, fn) for k, fn in ops.items()}
    torch.cuda.synchronize()
    # read before the graph timings: a capture counts calls that launch
    # nothing, and a replay launches kernels that no wrapper counts
    counts = {n: w.launches for n, w in wrappers.items()}
    tg = {k: graph_ms(torch, fn) for k, fn in ops.items()}

    def overlap(t):
        lo, hi = max(t["attn"], t["mm"]), t["attn"] + t["mm"]
        return lo, hi, (hi - t["fused"]) / min(t["attn"], t["mm"])

    lo, hi, hidden = overlap(t)
    glo, ghi, ghidden = overlap(tg)
    print(f"[probe fused] Ba={Ba} rows of {p['B']}, S={p['S']}, lens "
          f"{p['S'] - 7}; INT4 {cfg.hidden_size}x{cfg.intermediate_size} gs "
          f"{gs} at Mb={p['Mb']}: t_attn {t['attn']:.4f} ms | t_mm "
          f"{t['mm']:.4f} ms | t_fused {t['fused']:.4f} ms | full overlap "
          f"(max) {lo:.4f}, none (sum) {hi:.4f}: {100 * hidden:.0f}% of the "
          f"smaller op hidden | in a CUDA graph: t_attn {tg['attn']:.4f} | "
          f"t_mm {tg['mm']:.4f} | t_fused {tg['fused']:.4f} | max "
          f"{glo:.4f}, sum {ghi:.4f}: {100 * ghidden:.0f}% hidden | "
          f"launches { {n: c for n, c in counts.items() if c} }", flush=True)
    want = ("fused_attn_matmul", "decode_attention_contiguous",
            "quant_matmul4")
    stray = sorted(n for n in counts if n not in want and counts[n])
    if any(counts[n] <= 0 for n in want) or stray:
        fail(f"[probe fused] launches {counts}")
    del o, kc_a, vc_a
    torch.cuda.empty_cache()
    return counts, dict(t_attn_ms=t["attn"], t_mm_ms=t["mm"],
                        t_fused_ms=t["fused"], max_ms=lo, sum_ms=hi,
                        hidden_share=hidden, graph_t_attn_ms=tg["attn"],
                        graph_t_mm_ms=tg["mm"], graph_t_fused_ms=tg["fused"],
                        graph_max_ms=glo, graph_sum_ms=ghi,
                        graph_hidden_share=ghidden)


def device_rows(torch, prof):
    """(name, device ms, count) of what a profile saw run on the device:
    kernels, copies, sets.  A PyTorch op's own row carries the device time
    of the kernels it launched, which have rows of their own, so a sum over
    every row with device time counts PyTorch's kernels twice (the port's
    ctypes launches, which no op encloses, once)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]


def _step_chain(torch, step, steps, first, tok, lens, cache):
    """``steps`` greedy decode steps from position ``lens + first``;
    returns (tok, cache) after a device sync."""
    for s in range(steps):
        logits, cache = step(tok, lens + first + s, cache)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    return tok, cache


def _profile_steps(torch, fn, steps):
    """Device busy ms and kernel count of ``fn()`` (``steps`` decode steps
    or ticks) under torch.profiler, per step, and its top 8 kernels by
    device time (name, ms, count over the run); kernels replayed from a
    CUDA graph count as the eager ones do."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(torch, prof)
    busy = sum(ms for _, ms, _ in rows) / steps
    n_kernels = sum(n for _, _, n in rows) / steps
    top = sorted(rows, key=lambda r: -r[1])[:8]
    if busy <= 0:
        fail("profile: the profiler saw no device time")
    return busy, n_kernels, top


def _top_per_step(top, steps, n=4):
    """The first ``n`` of ``_profile_steps``' top kernels, ms a step."""
    return [(k[:40], round(ms / steps, 4)) for k, ms, _ in top[:n]]


def run_pumped_generate(torch, cfg, params, wrappers, prompts):
    """[pumped generate]: Qwen2.5-7B at full width and depth with the JAX
    bench's pumped weights (W4A16 gs 256 pad-free, INT4 lm_head) through
    ``Engine(..., pumped=True).generate`` on an aligned batch of 192 x
    256-token prompts (max_seq 512, bf16 KV, 32 new tokens).  Each decode
    step must launch fused_attn_mlp and kv_append_uniform 2 x 28 times and
    quant_matmul4 8 x 28 + 3 + 1 times, and no decode attention or
    fused_mlp.  Then the same batch through an engine of the default
    dispatch (no pump): each decode step must launch fused_mlp and the
    appending decode attention 28 times and quant_matmul4 4 x 28 + 1 times,
    and neither pumped kernel; its tok/s stands beside the pumped run's.
    Then, from
    one prefill of the same batch, 8 pumped steps and 8 plain
    ``decode_step(uniform_decode=True)`` steps (the yardstick: fused_mlp
    28 times a step at M = 192) by the host clock, each followed by 4 more
    under the profiler; and [deferred decode]: 8 more of
    ``decode_step(uniform_decode=True, deferred_append=True)`` from the same
    prefill, each launching the fresh-merge attention 28 times, the
    all-layer append once and the appending attention never.  The timed
    deferred steps' launches join the run's counts."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    B, L = PUMP_BATCH, cfg.num_layers
    eng = Engine(cfg, params, max_batch=B, max_seq=PUMP_SEQ,
                 kv_dtype=torch.bfloat16, sampling=SamplingParams(greedy=True),
                 device="cuda", pumped=True)
    if not qwen.pumped_supported(cfg, params, eng.new_cache(), B):
        fail("[pumped generate]: pumped_supported refuses the pumped weights")
    torch.cuda.empty_cache()
    eng.generate(prompts([16] * B), max_new_tokens=3)  # warm-up, capture
    batch = prompts([PUMP_PROMPT] * B)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = eng.generate(batch, max_new_tokens=NEW_TOKENS)
    counts = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = res.steps - 1
    ids = [t for row in res.token_ids for t in row]
    want = {"fused_attn_mlp": 2 * L * steps,
            "kv_append_uniform": 2 * L * steps,
            "quant_matmul4": (7 * L + 1) + steps * (8 * L + 3 + 1),
            "flash_attention": L, "fused_mlp": 0,
            "decode_attention_appending": 0}
    got = {n: counts[n] for n in want}
    stray = sorted(n for n in counts if n not in want and counts[n])
    print(f"[pumped generate] {cfg.name} W4A16 gs 256 pad-free + int4 "
          f"lm_head, batch {B} x {PUMP_PROMPT}, bf16 KV: ttft "
          f"{res.ttft_s * 1e3:.1f} ms | decode {res.decode_tokens_per_s:.1f} "
          f"tok/s | steps {res.steps} | peak {peak:.2f} GiB | launches "
          f"{ {n: c for n, c in counts.items() if c} }", flush=True)
    print(f"      first ids {[row[:8] for row in res.token_ids[:4]]}")
    if not all(0 <= t < cfg.vocab_size for t in ids) or len(set(ids)) < 2:
        fail("[pumped generate]: ids out of range or all identical")
    if got != want or stray:
        fail(f"[pumped generate]: launches {got}, expected {want} "
             f"({steps} decode steps); stray {stray}")

    # the default dispatch (Engine without pumped=True) on the same batch
    plain_eng = Engine(cfg, params, max_batch=B, max_seq=PUMP_SEQ,
                       kv_dtype=torch.bfloat16,
                       sampling=SamplingParams(greedy=True), device="cuda")
    plain_eng.generate(prompts([16] * B), max_new_tokens=3)  # warm-up
    for w in wrappers.values():
        w.launches = 0
    res_plain = plain_eng.generate(batch, max_new_tokens=NEW_TOKENS)
    plain_counts = {n: w.launches for n, w in wrappers.items()}
    p_steps = res_plain.steps - 1
    want_plain = {"fused_attn_mlp": 0, "kv_append_uniform": 0,
                  "quant_matmul4": (7 * L + 1) + p_steps * (4 * L + 1),
                  "flash_attention": L, "fused_mlp": L * p_steps,
                  "decode_attention_appending": L * p_steps}
    got_plain = {n: plain_counts[n] for n in want_plain}
    stray = sorted(n for n in plain_counts
                   if n not in want_plain and plain_counts[n])
    print(f"[pumped generate] the default dispatch (no pump), batch {B} x "
          f"{PUMP_PROMPT}: ttft {res_plain.ttft_s * 1e3:.1f} ms | decode "
          f"{res_plain.decode_tokens_per_s:.1f} tok/s (pumped "
          f"{res.decode_tokens_per_s:.1f}) | steps {res_plain.steps} | "
          f"launches { {n: c for n, c in plain_counts.items() if c} }",
          flush=True)
    if got_plain != want_plain or stray:
        fail(f"[pumped generate] default dispatch: launches {got_plain}, "
             f"expected {want_plain} ({p_steps} decode steps); stray {stray}")
    for n in wrappers:
        counts[n] += plain_counts[n]
    del plain_eng

    dev = eng.device
    toks = torch.tensor(batch, device=dev)
    lens = torch.full((B,), PUMP_PROMPT, device=dev)
    n = PUMP_YARDSTICK_STEPS

    def measure(step, cache, tok):
        """One warm-up step, n steps by the host clock (with launch counts
        a step), then 4 more under the profiler."""
        tok, _ = _step_chain(torch, step, 1, 0, tok, lens, cache)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        tok, _ = _step_chain(torch, step, n, 1, tok, lens, cache)
        wall = (time.perf_counter() - t0) * 1e3 / n
        launches = {k: w.launches / n for k, w in wrappers.items()
                    if w.launches}
        total = {k: w.launches for k, w in wrappers.items()}
        busy, n_k, top = _profile_steps(
            torch, lambda: _step_chain(torch, step, 4, 1 + n, tok, lens,
                                       cache), 4)
        return dict(step_ms=wall, launches_per_step=launches,
                    device_busy_ms=busy, kernels=n_k, busy_share=busy / wall,
                    top=[(k[:50], ms, cnt) for k, ms, cnt in top],
                    launches_total=total)

    with torch.inference_mode():
        logits, cache = qwen.prefill_chunked(params, cfg, toks, lens,
                                             eng.new_cache(), chunk=512)
        other = KVCache(k=cache.k.clone(), v=cache.v.clone())
        deferred = KVCache(k=cache.k.clone(), v=cache.v.clone())
        tok0 = logits.argmax(-1)
        out = {"pumped": measure(
                   lambda t, p, c: qwen.decode_step_pumped(params, cfg, t, p,
                                                           c), cache, tok0),
               "plain": measure(
                   lambda t, p, c: qwen.decode_step(params, cfg, t, p, c,
                                                    uniform_decode=True),
                   other, tok0),
               "deferred": measure(
                   lambda t, p, c: qwen.decode_step(params, cfg, t, p, c,
                                                    uniform_decode=True,
                                                    deferred_append=True),
                   deferred, tok0)}
    for name in ("pumped", "plain", "deferred"):
        r = out[name]
        print(f"[pumped generate profile] {name} decode step at batch {B}: "
              f"{r['step_ms']:.2f} ms on the host clock ({n} steps), device "
              f"busy {r['device_busy_ms']:.2f} ms (busy share "
              f"{r['busy_share']:.3f}), {r['kernels']:.0f} device kernels | "
              f"launches a step {r['launches_per_step']} | by device time "
              f"over 4 steps: " + "; ".join(f"{k} {ms:.2f} ms x{cnt}"
                                            for k, ms, cnt in r["top"]),
              flush=True)
    per = out["plain"]["launches_per_step"]
    if per.get("fused_mlp") != L or per.get("decode_attention_appending") != L:
        fail(f"the plain yardstick step launched {per}: expected fused_mlp "
             f"and decode_attention_appending {L} times")
    per = out["pumped"]["launches_per_step"]
    if per.get("fused_attn_mlp") != 2 * L or "fused_mlp" in per:
        fail(f"the pumped step launched {per}")
    per = out["deferred"]["launches_per_step"]
    print(f"[deferred decode] batch {B}: a step {out['deferred']['step_ms']:.2f}"
          f" ms on the host clock (plain decode_step "
          f"{out['plain']['step_ms']:.2f}), device busy "
          f"{out['deferred']['device_busy_ms']:.2f} ms (plain "
          f"{out['plain']['device_busy_ms']:.2f}), busy share "
          f"{out['deferred']['busy_share']:.3f} (plain "
          f"{out['plain']['busy_share']:.3f}) | launches a step {per}",
          flush=True)
    if per.get("decode_attention_contiguous_fresh") != L \
            or per.get("kv_append_all_uniform") != 1 \
            or "decode_attention_appending" in per:
        fail(f"[deferred decode]: a step launched {per}; want the fresh "
             f"attention {L} times, the all-layer append once and no "
             f"appending attention")
    for n in ("decode_attention_contiguous_fresh", "kv_append_all_uniform"):
        counts[n] += out["deferred"]["launches_total"][n]
    for r in out.values():
        del r["launches_total"]
    del eng, cache, other, deferred
    torch.cuda.empty_cache()
    return counts, dict(ttft_ms=res.ttft_s * 1e3,
                        decode_tok_s=res.decode_tokens_per_s, steps=res.steps,
                        default_dispatch_ttft_ms=res_plain.ttft_s * 1e3,
                        default_dispatch_decode_tok_s=(
                            res_plain.decode_tokens_per_s),
                        peak_gib=peak, pumped=out["pumped"],
                        plain=out["plain"])


def pumped_model_check(torch, cfg4, params4, prompts):
    """Phase 5's pumped rule: the 4-layer pumped model (W4A16 gs 256
    pad-free, INT4 lm_head) prefills 192 aligned 64-token prompts, then
    takes 2 decode steps fed the same tokens: by ``decode_step_pumped``
    with the kernels and with every plain version (bf16), by
    ``decode_step`` with the kernels (fused_mlp at M = 192) and the plain
    versions, and by the deferred-append ``decode_step`` likewise; each
    kernel path at most 1.5x as far from an fp32 run of the plain
    ``decode_step`` (f32 params and cache, the plain f32 matmuls and
    attention) as its plain bf16 path is.  The deferred rule: after its
    first step, the cache the deferred step wrote equals the one
    ``decode_step(uniform_decode=True)`` wrote, bit for bit."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs

    B, T, n_steps = PUMP_BATCH, 64, 2
    toks = torch.tensor(prompts([T] * B), device="cuda")
    feed = torch.tensor(prompts([n_steps] * B), device="cuda")
    lens = torch.full((B,), T, device="cuda")
    params4_f32 = qwen.map_params(
        params4, lambda t: t.float() if t.is_floating_point() else t)

    def run(p, dtype, mode, first=None):
        """The logits of n_steps steps; ``first`` (a list) takes a copy of
        the cache after the first step."""
        cache = KVCache.create(cfg4.num_layers, B, 256, cfg4.num_kv_heads,
                               cfg4.head_dim, dtype=dtype, device="cuda")
        out = []
        with torch.inference_mode():
            _, cache = qwen.prefill_chunked(p, cfg4, toks, lens, cache)
            for s in range(n_steps):
                if mode == "pumped":
                    logits, cache = qwen.decode_step_pumped(
                        p, cfg4, feed[:, s], lens + s, cache)
                else:
                    logits, cache = qwen.decode_step(
                        p, cfg4, feed[:, s], lens + s, cache,
                        uniform_decode=True,
                        deferred_append=mode == "deferred")
                out.append(logits)
                if s == 0 and first is not None:
                    first.append((cache.k.clone(), cache.v.clone()))
        return torch.cat(out, 0)

    with Swapped(f32_swaps()):
        lr = run(params4_f32, torch.float32, "plain")
    del params4_f32
    caches = []
    for label, mode, kern, per_layer in (
            ("pumped decode", "pumped", fs.fused_attn_mlp, 2),
            ("plain decode (fused_mlp)", "plain", fs.fused_mlp, 1),
            ("deferred-append decode", "deferred",
             da.decode_attention_contiguous_fresh, 1)):
        before = kern.launches
        lk = run(params4, torch.bfloat16, mode,
                 caches if mode != "pumped" else None)
        want = n_steps * cfg4.num_layers * per_layer
        if kern.launches - before != want:
            fail(f"{label}: the model check launched {kern.__name__} "
                 f"{kern.launches - before} times, not {want}")
        with Swapped(plain_swaps()):
            lp = run(params4, torch.bfloat16, mode)
        model_check(f"W4A16 gs 256 pad-free + int4 lm_head, batch {B} x {T}, "
                    f"{label}", lk, lp, lr,
                    what=f"the logits of {n_steps} decode steps")
    (k_plain, v_plain), (k_def, v_def) = caches
    same = bool(torch.equal(k_plain, k_def) and torch.equal(v_plain, v_def))
    print(f"[model] 4 layers, deferred-append decode: the cache after one "
          f"step equals decode_step(uniform_decode=True)'s bit for bit: "
          f"{same}", flush=True)
    if not same:
        fail("deferred-append decode: its cache after one step differs from "
             "decode_step(uniform_decode=True)'s")


# ----------------------------------------------------------------------
# phases 4 and 5
# ----------------------------------------------------------------------

def model_check(label, lk, lp, lr, extra="", what="prefill logits"):
    """The kernel path's logits ``lk`` may be at most 1.5x as far from the
    fp32 plain run ``lr`` as the plain bf16 path's ``lp`` are."""
    if not bool(lk.isfinite().all()):
        fail(f"{label}: non-finite logits on the kernel path")
    dlogit = (lk - lp).abs().max().item()
    err_k = (lk - lr).abs().max().item()
    err_p = (lp - lr).abs().max().item()
    tol = 1.5 * err_p
    print(f"[model] 4 layers, {label}, {what} on the card: kernels vs "
          f"plain versions max |dlogit| {dlogit:.4g} (max|logit| "
          f"{lr.abs().max().item():.4g}) | vs the fp32 plain path: kernels "
          f"{err_k:.4g}, plain bf16 {err_p:.4g} (tol: kernels <= 1.5 x plain "
          f"= {tol:.4g}){extra}", flush=True)
    if not err_k <= tol:
        fail(f"{label}: kernel path is {err_k} from the fp32 path, > {tol}")


class Swapped:
    """Swap module attributes for the length of a ``with`` block: the smoke
    run calls the plain versions by name this way, never the wrappers."""

    def __init__(self, swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.swaps]
        for m, n, f in self.swaps:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def attention_swaps():
    """The attention and append kernels of the model replaced by their
    plain versions."""
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    return [(qwen, "flash_attention", fa.flash_attention_plain),
            (qwen, "paged_decode_attention_stacked",
             pa.paged_decode_attention_plain),
            (qwen, "paged_decode_attention_stacked_q8",
             pa.paged_decode_attention_q8_plain),
            (qwen, "paged_verify_attention_stacked",
             pa.paged_decode_attention_plain),
            (qwen, "paged_verify_attention_stacked_q8",
             pa.paged_decode_attention_q8_plain),
            (qwen, "paged_chunk_attention", ca.paged_chunk_attention_plain),
            (qwen, "paged_chunk_attention_q8",
             ca.paged_chunk_attention_q8_plain),
            (qwen, "paged_append_ragged", ka.paged_append_ragged_plain),
            (qwen, "paged_append_ragged_t", ka.paged_append_ragged_t_plain),
            (qwen, "paged_append_prefill", ka.paged_append_prefill_plain),
            (qwen, "chunk_attention_contiguous",
             ca.chunk_attention_contiguous_plain),
            (qwen, "chunk_attention_contiguous_q8",
             ca.chunk_attention_contiguous_q8_plain),
            (qwen, "decode_attention_contiguous",
             da.decode_attention_contiguous_plain),
            (qwen, "decode_attention_appending",
             da.decode_attention_appending_plain),
            (qwen, "decode_attention_contiguous_q8",
             da.decode_attention_contiguous_q8_plain),
            (qwen, "kv_append_uniform_q8", ka.kv_append_uniform_q8_plain),
            (qwen, "kv_append_uniform", ka.kv_append_uniform_plain),
            (qwen, "kv_append_ragged_t", ka.kv_append_ragged_t_plain),
            (qwen, "decode_attention_contiguous_fresh",
             da.decode_attention_contiguous_fresh_plain),
            (qwen, "kv_append_all_uniform", ka.kv_append_all_uniform_plain)]


def plain_swaps():
    """Every kernel replaced by its plain version (bf16, as the kernels
    compute)."""
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm

    return ([(qm, n, getattr(qm, n + "_plain"))
             for n in MATMULS]
            + [(gm, n, getattr(gm, n + "_plain")) for n in GROUPED]
            + [(qwen, n, getattr(fs, n + "_plain"))
               for n in ("fused_mlp", "fused_attn_mlp")]
            + attention_swaps())


def f32_swaps():
    """An fp32 reference path: the plain dequant matmul of ops/linear.py
    (the code the CPU tests hold against the JAX package) in place of the
    bf16 dispatchers (dense and grouped) and of the fused MLP (three f32
    matmuls, no bf16 rounding of x or h), and the plain attention."""
    import torch

    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.linear import (
        QuantLinear,
        quant_matmul,
    )

    def stacked(x, lin, layer, act_bits=0, amax_group=None):
        return quant_matmul(x, lin.layer_slice(layer), act_bits=act_bits,
                            amax_group=amax_group)

    def mlp(x, wg, sg, wu, su, wd, sd, layer, *, gs_gate, gs_down):
        def mm(a, q, sc, gs):
            return quant_matmul(a.float(), QuantLinear(
                q=q[layer], scales=sc[layer], b=None, bits=4, group_size=gs))

        h = torch.nn.functional.silu(mm(x, wg, sg, gs_gate)) * mm(x, wu, su,
                                                                  gs_gate)
        return mm(h, wd, sd, gs_down).to(x.dtype)

    return [(qm, "quant_matmul_stacked", stacked),
            (qwen, "grouped_quant_matmul", grouped_f32(torch)),
            (qwen, "fused_mlp", mlp), *attention_swaps()]


SERVE_LENS = [37, 120, 256, 300, 511, 512, 513, 700, 900, 1100, 1300, 1408]
SHARED = 1100       # the second wave's prefix, taken from the 1300 prompt
NEW_TOKENS = 32


def count_calls(obj, name, counter):
    """Count the calls of a method of ``obj`` (instance attribute)."""
    orig = getattr(obj, name)

    def wrapped(*a, **k):
        counter[name] = counter.get(name, 0) + 1
        return orig(*a, **k)

    setattr(obj, name, wrapped)


def run_serving(torch, np, cfg, params, wrappers, rng,
                kv_dtype=None):
    """The serving path at the JAX defaults (8 slots, pages of 512, pieces
    of 256, prefix cache on, 8 ticks per sync) over a bf16 or an INT8 page
    pool: 12 greedy requests onto 8 slots, then 4 that share an 1100-token
    prefix with a finished one.  Returns the launch counts of the run and
    its numbers."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    q8 = kv_dtype == torch.int8
    label = "[serve int8]" if q8 else "[serve]"
    sfx = "_q8" if q8 else ""
    # sized as `qie serve` sizes it at --max-seq 2048: 4 pages per sequence
    # and 8 x 4 + 8 pages in the pool
    cb = ContinuousBatchingEngine(
        cfg, params, max_slots=8, page_size=PAGE, num_pages=40,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
        sampling=SamplingParams(greedy=True),
        kv_dtype=kv_dtype or torch.bfloat16, device="cuda")
    # random weights can argmax onto EOS and end a request early
    cb._eos = set()
    calls = {}
    for name in ("_decode_tick", "_run_piece", "_mixed_chain_batch"):
        count_calls(cb, name, calls)
    first = [rng.integers(0, cfg.vocab_size, size=n).tolist()
             for n in SERVE_LENS]
    base = first[SERVE_LENS.index(1300)][:SHARED]
    second = [base + rng.integers(0, cfg.vocab_size, size=n).tolist()
              for n in (40, 100, 150, 200)]
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = []
    for wave, prompts in enumerate((first, second)):
        for i, p in enumerate(prompts):
            cb.submit(Request(request_id=100 * wave + i, prompt=p,
                              max_new_tokens=NEW_TOKENS))
        done += cb.run_to_completion(sync_every=8)
        cb.check_page_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    snap = cb.metrics.snapshot()
    print(f"{label} {cfg.name} {cfg.num_layers} layers, 8 slots, page {PAGE}, "
          f"pieces of 256, prefix cache on: {len(done)} requests (prompts "
          f"{SERVE_LENS} then 4 x {SHARED} shared + 40-200) in {wall:.2f} s | "
          f"TTFT p50 {snap['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{snap['ttft_p99_s'] * 1e3:.1f} ms | decode "
          f"{snap['decode_tokens_per_s']:.1f} tok/s ({snap['decode_tokens']} "
          f"tokens) | prefix hits {snap['prefix_hit_tokens']} tokens | decode "
          f"ticks {calls.get('_decode_tick', 0)}, pieces "
          f"{calls.get('_run_piece', 0)}, mixed windows "
          f"{calls.get('_mixed_chain_batch', 0)} | launches {counts}",
          flush=True)
    ids = [t for f in done for t in f.token_ids]
    bad = [f.request_id for f in done
           if f.finish_reason != "length" or len(f.token_ids) != NEW_TOKENS]
    if len(done) != 16 or bad:
        fail(f"serving: {len(done)} of 16 requests done, not by length: {bad}")
    if not all(0 <= t < cfg.vocab_size for t in ids) or len(set(ids)) < 2:
        fail("serving: ids out of range or all identical")
    must = {"quant_matmul4_a8", "flash_attention", "paged_append_prefill",
            "paged_chunk_attention" + sfx, "paged_append_ragged",
            "paged_decode_attention_stacked" + sfx}
    missing = sorted(n for n in must if counts[n] <= 0)
    stray = sorted(n for n in counts if n not in must and counts[n] != 0)
    if missing or stray:
        fail(f"{label}: kernels of its path not launched {missing}, "
             f"kernels of other paths launched {stray}")
    L = cfg.num_layers
    ticks = calls.get("_decode_tick", 0)
    if counts["paged_decode_attention_stacked" + sfx] != L * ticks or \
            counts["paged_append_ragged"] != L * ticks:
        fail(f"{label}: {ticks} decode ticks but paged decode / append "
             f"launches {counts['paged_decode_attention_stacked' + sfx]} / "
             f"{counts['paged_append_ragged']} (want {L} per tick)")
    if counts["paged_append_prefill"] != L * calls.get("_run_piece", 0):
        fail("serving: one paged_append_prefill per layer per piece expected")
    if snap["prefix_hit_tokens"] < 4 * 2 * PAGE or \
            calls.get("_mixed_chain_batch", 0) == 0:
        fail(f"serving: prefix hits {snap['prefix_hit_tokens']} (want >= "
             f"{4 * 2 * PAGE}), mixed windows {calls.get('_mixed_chain_batch')}")
    resend = resend_near_max_seq(torch, cb, cfg, rng,
                                 wrappers["paged_chunk_attention" + sfx])
    window = profile_decode_window(torch, cb, cfg, rng, label=label)
    del cb
    torch.cuda.empty_cache()
    return counts, dict(wall_s=wall, ticks=ticks, **snap, **resend, **window)


def resend_near_max_seq(torch, cb, cfg, rng, chunk):
    """A 2040-token prompt (8 new tokens: the whole 4-page table) sent
    twice: the second request hits 3 whole pages and 503 rows of the
    fourth, and its last piece (start 2039, padded to 16) runs past the
    table.  Both must finish by length, the second through one paged chunk
    per layer.  Between the two sends the pool's bytes (and an INT8 pool's
    scales) at the prompt's rows and the first token's logits are compared
    (``compare_resend``): every hit row must be byte-equal (the prefix
    cache's pages and its partial-page copy).  The last row is computed in
    a 16-row piece on the second send and in a 248-row one on the first,
    where the dense matmuls' plans differ (K split at M <= 64, one slice
    above: another f32 order), so it may drift by a rounding, amplified
    layer by layer and across INT8 KV's rounding boundaries; it is
    printed, not held equal.  A second prompt is then sent twice with every
    dense matmul on the one-slice plan (``one_slice_plan``): the two sends
    must then agree in every pool byte, in the logits and in the tokens."""
    out = _resend(torch, cb, cfg, rng, chunk, exact=False)
    with one_slice_plan():
        exact = _resend(torch, cb, cfg, rng, chunk, exact=True)
    return {"resend_tokens_equal": out[0], "resend_pool": out[1],
            "resend_one_slice_tokens_equal": exact[0]}


@contextlib.contextmanager
def one_slice_plan():
    """Within it, every dense quantized matmul runs one K slice, at any M
    (``plan_split_k`` returns the prefill plan): a row's sums fold in one
    order whatever the piece it is computed in."""
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm

    plan = qm.plan_split_k
    qm.plan_split_k = lambda M, rows, N, unit: (0, 1, rows)
    try:
        yield
    finally:
        qm.plan_split_k = plan


def _resend(torch, cb, cfg, rng, chunk, exact):
    """One resend of a fresh 2040-token prompt; returns (tokens equal, the
    pool comparison).  ``exact``: the last row, the logits and the tokens
    must agree too."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import Request
    # the serving engine's pieces are tp_step's makers: a last piece's
    # logits are the makers' compute_logits
    from qwen_inference_engine_tpu_torch.parallel import tp_step

    prompt = rng.integers(0, cfg.vocab_size, size=2040).tolist()
    hits0 = cb.metrics.snapshot()["prefix_hit_tokens"]
    done, tables, logits, pools = [], [], [], []
    run_piece, compute_logits = cb._run_piece, tp_step.compute_logits

    def piece(run, tokens, start, nvalid, table, last):
        if last:
            tables.append(table[0].long().clone())
        return run_piece(run, tokens, start, nvalid, table, last)

    def first_logits(*a, **k):
        out = compute_logits(*a, **k)
        logits.append(out.float().clone())
        return out

    cb._run_piece, tp_step.compute_logits = piece, first_logits
    try:
        for rid in (300, 301):
            before = chunk.launches
            cb.submit(Request(request_id=rid, prompt=prompt, max_new_tokens=8))
            done += cb.run_to_completion(sync_every=8)
            cb.check_page_invariants()
            pools.append(prompt_rows(torch, cb.cache, tables[-1], len(prompt)))
    finally:
        cb._run_piece, tp_step.compute_logits = run_piece, compute_logits
    hits = cb.metrics.snapshot()["prefix_hit_tokens"] - hits0
    pieces = (chunk.launches - before) // cfg.num_layers
    same = done[0].token_ids == done[1].token_ids
    cmp = compare_resend(torch, pools[0], pools[1], logits[0], logits[1])
    plan = "one-slice plan" if exact else "default plan"
    print(f"[serve] 2040-token prompt sent twice ({plan}): finish "
          f"{[(f.finish_reason, len(f.token_ids)) for f in done]}, second "
          f"request's prefix hits {hits}, its continuation pieces {pieces}, "
          f"tokens equal {same} ({done[0].token_ids} / {done[1].token_ids}) "
          f"| pool between the sends: {json.dumps(cmp)}", flush=True)
    if [f.request_id for f in done] != [300, 301] or any(
            f.finish_reason != "length" or len(f.token_ids) != 8 for f in done):
        fail(f"serving: the resent 2040-token prompt did not finish: "
             f"{[(f.request_id, f.finish_reason) for f in done]}")
    if hits != 2039 or pieces != 1:
        fail(f"serving: the resent prompt hit {hits} tokens (want 2039) in "
             f"{pieces} pieces (want 1)")
    tensors = [v for n, v in cmp.items() if n != "logits"]
    hit_differ = sum(v["hit_rows_differ"] for v in tensors)
    last_differ = sum(v["last_row_differ"] for v in tensors)
    if hit_differ or exact and (last_differ or cmp["logits"]["max_abs"]
                                or not same):
        fail(f"serving: the resent prompt ({plan}) differs from the first "
             f"send: {hit_differ} hit-row elements, {last_differ} last-row "
             f"elements, logits by {cmp['logits']['max_abs']}, tokens equal "
             f"{same} (want 0 hit-row elements"
             + (", and all equal)" if exact else ")"))
    return same, cmp


def prompt_rows(torch, cache, table, n):
    """The pool's K / V (and an INT8 pool's scales) at positions 0..n-1
    through one block table, as [L, Hk, n, ...] copies."""
    out = []
    for t in (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale):
        if t is None:
            continue
        pages = t[:, table]                       # [L, NP, Hk, page, ...]
        L, NP, Hk, PS = pages.shape[:4]
        out.append(pages.transpose(1, 2).reshape(L, Hk, NP * PS,
                                                 *pages.shape[4:])[:, :, :n]
                   .clone())
    return out


def compare_resend(torch, first, second, logits1, logits2):
    """Where two sends of one prompt differ: each tensor's elements that
    differ at the hit rows (all but the last prompt row) and at the last
    row, and the layers where the last row differs; the last row's largest
    difference (int8: in steps, |q1 - q2|); and the first token's
    logits."""
    names = ("k", "v", "k_scale", "v_scale")[:len(first)]
    out = {}
    for name, a, b in zip(names, first, second):
        diff = a != b                                   # [L, Hk, n, ...]
        hit, last = diff[:, :, :-1], diff[:, :, -1]
        layers = [int(i) for i in torch.nonzero(
            last.reshape(last.shape[0], -1).any(dim=1)).flatten()]
        out[name] = dict(hit_rows_differ=int(hit.sum()),
                         last_row_differ=int(last.sum()),
                         last_row_layers=layers)
        gap = float((a[:, :, -1].float() - b[:, :, -1].float()).abs().max())
        key = ("last_row_max_q_diff" if a.dtype == torch.int8
               else "last_row_max_abs")
        out[name][key] = gap
    d = (logits1 - logits2).abs()
    top1, top2 = logits1.topk(2, dim=-1).values[0].tolist()
    out["logits"] = dict(max_abs=float(d.max()),
                         argmax=[int(logits1.argmax()), int(logits2.argmax())],
                         first_send_top2_gap=top1 - top2)
    return out


def profile_decode_window(torch, cb, cfg, rng, ticks=8, label="[serve]"):
    """Where a serving decode window's time goes: 8 requests fill the 8
    slots (300-token prompts), then one chained window of ``ticks`` decode
    ticks is timed by the host clock, and the next one again under
    ``torch.profiler`` (device busy time, idle share, kernels by device
    time).  Run after the serving run's launch counts were read."""
    from torch.profiler import ProfilerActivity, profile

    from qwen_inference_engine_tpu_torch.engine.scheduler import Request

    for i in range(cb.max_slots):
        cb.submit(Request(request_id=200 + i, max_new_tokens=64,
                          prompt=rng.integers(0, cfg.vocab_size,
                                              size=300).tolist()))
    while cb.num_pending or any(s is None or not s.prefill_done
                                for s in cb._slots):
        cb.step_batch(ticks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb.step_batch(ticks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cb.step_batch(ticks)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(torch, prof)
    busy_ms = sum(ms for _, ms, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    cb.run_to_completion()
    # the profiler's own host cost stretches its window; the device work of
    # the two windows is the same, so busy / the unprofiled window is the
    # busy share without the profiler
    idle = 1 - busy_ms / prof_wall_ms
    print(f"{label[:-1]} profile] a window of {ticks} decode ticks at "
          f"{cb.max_slots} busy slots: {wall_ms:.2f} ms ({wall_ms / ticks:.2f} "
          f"ms per tick); under the profiler {prof_wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms (idle share {idle:.3f} under the profiler; "
          f"busy {busy_ms / wall_ms:.3f} of the unprofiled window) | by "
          f"device time: "
          + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in top),
          flush=True)
    if busy_ms <= 0:
        fail("serving profile: the profiler saw no device time")
    return dict(window_ms=wall_ms, window_ticks=ticks,
                profiled_window_ms=prof_wall_ms, device_busy_ms=busy_ms,
                idle_share_profiled=idle,
                busy_share_unprofiled=busy_ms / wall_ms)


GRAPH_STEPS = 8     # [graph generate]'s decode steps, eager and captured
GRAPH_TICKS = 8     # [graph serve]'s window of decode ticks
GRAPH_SEED = 5
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, repetition_penalty=1.1)


def graph_generate_case(torch, eng, prompts, label, wrappers, sp=None,
                        steps=GRAPH_STEPS):
    """[graph generate]: one prefill (``Engine.start``), then the same
    ``steps`` decode steps captured and under ``step_graph.eager_steps()``,
    each from the same copy of the decode buffers (cache, tokens,
    positions, masks, the generator's state).  Logits, tokens and each
    step's launches must be equal bit for bit.  Then, from the same copy
    again, ``steps`` steps of each by the host clock and ``steps`` under
    the profiler.  Returns the case's numbers."""
    from qwen_inference_engine_tpu_torch.engine import step_graph

    sp = sp or eng.sampling
    eng.start(prompts, steps + 1, sp, seed=GRAPH_SEED)
    b = eng.buffers()
    snap = b.state()
    runs = {}
    for mode in ("captured", "eager"):
        ctx = (step_graph.eager_steps() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            b.load_state(snap)
            logits, per_step = [], []
            for _ in range(steps):
                before = {n: w.launches for n, w in wrappers.items()}
                logits.append(eng.decode().clone())
                per_step.append({n: w.launches - before[n]
                                 for n, w in wrappers.items()
                                 if w.launches != before[n]})
            tokens = b.out[:, :steps + 1].clone()
            b.load_state(snap)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.decode()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
            b.load_state(snap)
            busy, kernels, top = _profile_steps(
                torch, lambda: [eng.decode() for _ in range(steps)], steps)
        runs[mode] = dict(logits=logits, tokens=tokens, per_step=per_step,
                          step_ms=ms, device_busy_ms=busy, kernels=kernels,
                          top=_top_per_step(top, steps),
                          tok_s=len(prompts) * 1e3 / ms)
    cap, ref = runs["captured"], runs["eager"]
    logits_equal = all(torch.equal(x, y)
                       for x, y in zip(cap["logits"], ref["logits"]))
    tokens_equal = bool(torch.equal(cap["tokens"], ref["tokens"]))
    launches_equal = cap["per_step"] == ref["per_step"] and all(
        cap["per_step"])
    print(f"[graph generate] {label}, batch {eng.max_batch}, {steps} steps: "
          f"logits equal {logits_equal}, tokens equal {tokens_equal}, "
          f"launches a step equal {launches_equal} "
          f"({sum(cap['per_step'][-1].values())} a step) | captured "
          f"{cap['step_ms']:.2f} ms a step on the host clock, device busy "
          f"{cap['device_busy_ms']:.2f} ms, {cap['tok_s']:.1f} tok/s | eager "
          f"{ref['step_ms']:.2f} ms, device busy {ref['device_busy_ms']:.2f} "
          f"ms, {ref['tok_s']:.1f} tok/s | graphs {eng.graphs.captured}, "
          f"capture {eng.graphs.capture_s * 1e3:.0f} ms | captured top "
          f"{cap['top']}", flush=True)
    if not (logits_equal and tokens_equal and launches_equal):
        fail(f"[graph generate] {label}: captured and eager steps differ "
             f"(logits {logits_equal}, tokens {tokens_equal}, launches "
             f"{cap['per_step']} / {ref['per_step']})")
    return {m: {k: v for k, v in r.items()
                if k not in ("logits", "tokens", "per_step")}
            for m, r in runs.items()} | dict(
                launches_per_step=cap["per_step"][-1], batch=eng.max_batch,
                rows=len(prompts), graphs=eng.graphs.captured,
                capture_ms=eng.graphs.capture_s * 1e3)


def run_graph_generate(torch, cfg, cases, wrappers):
    """[graph generate] over several engines of one model: each case is
    (label, params, engine keywords, prompts, sampling or None).  Returns
    (the launches of the cases' runs, their numbers)."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    before = {n: w.launches for n, w in wrappers.items()}
    out = {}
    for label, params, kw, prompts, sp in cases:
        ccfg = kw.pop("cfg", cfg)
        eng = Engine(ccfg, params, sampling=SamplingParams(greedy=True),
                     device="cuda", **kw)
        out[label] = graph_generate_case(torch, eng, prompts, label, wrappers,
                                         sp=sp)
        del eng
        torch.cuda.empty_cache()
    return {n: w.launches - before[n] for n, w in wrappers.items()}, out


def graph_serve_case(torch, cfg, params, wrappers, rng, kv_dtype, max_pages,
                     eager=True, ticks=GRAPH_TICKS):
    """[graph serve]: two serving engines (8 slots, pages of 512, pool
    ``kv_dtype``, ``max_pages`` pages a sequence), the same 8 requests of
    300-token prompts filling the slots; then windows of ``ticks`` decode
    ticks, one engine's captured, the other's under eager_steps(): one
    window to warm up (the key's first tick, the capture), one by the host
    clock, one under the profiler.  Every request's tokens must be equal
    between the two; the captured engine holds one graph.  ``eager``
    False: the captured engine alone (its tick's numbers)."""
    from qwen_inference_engine_tpu_torch.engine import step_graph
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    prompts = [rng.integers(0, cfg.vocab_size, size=300).tolist()
               for _ in range(8)]
    before = {n: w.launches for n, w in wrappers.items()}
    runs, engines = {}, {}
    for mode in ("captured", "eager") if eager else ("captured",):
        ctx = (step_graph.eager_steps() if mode == "eager"
               else contextlib.nullcontext())
        cb = ContinuousBatchingEngine(
            cfg, params, max_slots=8, page_size=PAGE, num_pages=40,
            max_pages_per_seq=max_pages, prefill_chunk=256,
            prefix_cache=False, sampling=SamplingParams(greedy=True),
            kv_dtype=kv_dtype, device="cuda")
        cb._eos = set()
        for i, p in enumerate(prompts):
            cb.submit(Request(request_id=i, prompt=p, max_new_tokens=64))
        with ctx:
            while cb.num_pending or any(s is None or not s.prefill_done
                                        for s in cb._slots):
                cb.step()
            cb.step_batch(ticks)                       # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cb.step_batch(ticks)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / ticks
            busy, kernels, top = _profile_steps(
                torch, lambda: cb.step_batch(ticks), ticks)
        runs[mode] = dict(tick_ms=ms, device_busy_ms=busy,
                          busy_share=busy / ms, kernels=kernels,
                          top=_top_per_step(top, ticks),
                          graphs=cb.graphs.captured,
                          capture_ms=cb.graphs.capture_s * 1e3)
        engines[mode] = cb
    toks = {m: [list(s.generated) for s in cb._slots]
            for m, cb in engines.items()}
    equal = toks["captured"] == toks.get("eager", toks["captured"])
    cap = runs["captured"]
    ref = runs.get("eager", dict(graphs=0))
    label = f"{'INT8' if kv_dtype == torch.int8 else 'bf16'} pool"
    print(f"[graph serve] {cfg.name} {cfg.num_layers} layers, {label}, "
          f"max_pages_per_seq {max_pages}: windows of {ticks} ticks at 8 "
          f"busy slots, tokens equal {equal if eager else '(no eager run)'}"
          f" ({len(toks['captured'][0])} a slot) | captured "
          f"{cap['tick_ms']:.2f} ms a tick, device busy "
          f"{cap['device_busy_ms']:.2f} ms (busy share "
          f"{cap['busy_share']:.3f}), graphs {cap['graphs']} (capture "
          f"{cap['capture_ms']:.0f} ms)"
          + (f" | eager {ref['tick_ms']:.2f} ms, device busy "
             f"{ref['device_busy_ms']:.2f} ms (busy share "
             f"{ref['busy_share']:.3f})" if eager else "")
          + f" | captured top {cap['top']}", flush=True)
    if not equal or cap["graphs"] != 1 or ref["graphs"] != 0:
        fail(f"[graph serve] {label}, {max_pages} pages: captured and eager "
             f"ticks part (tokens equal {equal}) or graphs {cap['graphs']} "
             f"/ {ref['graphs']} (want 1 / 0)")
    del engines, cb
    torch.cuda.empty_cache()
    counts = {n: w.launches - before[n] for n, w in wrappers.items()}
    return counts, dict(runs, tokens_equal=equal, max_pages=max_pages)


def run_http_spec_int8(torch, cfg, params):
    """``qie serve --speculative --kv-bits 8``: the ``Server`` over an INT8
    pool with prompt-lookup speculation on 127.0.0.1 answers one /generate
    of an echo prompt, and /stats reports its speculation rounds."""
    import http.client
    import threading
    import types
    from http.server import ThreadingHTTPServer

    from qwen_inference_engine_tpu_torch.server.http import (
        Server,
        _make_handler,
    )
    from qwen_inference_engine_tpu_torch.tokenizer import ByteTokenizer

    args = types.SimpleNamespace(
        temperature=0.7, top_k=50, top_p=1.0, repetition_penalty=1.0,
        greedy=True, max_slots=8, page_size=PAGE, num_pages=0, max_seq=2048,
        kv_bits=8, seed=0, step_ticks=8, device="cuda", speculative=True,
        spec_k=SPEC_K, spec_ngram=3)
    server = Server(cfg, params, ByteTokenizer(), None, args)
    server.engine._eos = set()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    text = "The port reads the pages once. " * 6

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())

    try:
        t0 = time.perf_counter()
        st, gen = call("POST", "/generate", {"prompt": text,
                                             "max_new_tokens": 16})
        st2, stats = call("GET", "/stats")
        dt = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(timeout=30)
    print(f"[http spec int8] 127.0.0.1:{port} (int8 pool "
          f"{server.engine.cache.quantized}): /generate {st} "
          f"{len(gen.get('token_ids', []))} tokens ({gen.get('finish_reason')})"
          f" | /stats {st2}: spec rounds {stats.get('spec_rounds')}, tokens "
          f"per forward {stats.get('spec_tokens_per_forward')} | {dt:.2f} s",
          flush=True)
    if (st, st2) != (200, 200) or len(gen.get("token_ids", [])) != 16 \
            or not stats.get("spec_rounds", 0) > 0 \
            or not server.engine.cache.quantized:
        fail("http spec int8: a request failed or no speculation ran")
    if thread.is_alive() or server._thread.is_alive():
        fail("http spec int8: a server thread is still running")


def run_http(torch, cfg, params):
    """``Server`` on 127.0.0.1 at an ephemeral port over the same params:
    one /generate, one streamed /v1/completions, one /v1/chat/completions,
    then /stats."""
    import http.client
    import threading
    import types
    from http.server import ThreadingHTTPServer

    from qwen_inference_engine_tpu_torch.server.http import (
        Server,
        _make_handler,
    )
    from qwen_inference_engine_tpu_torch.tokenizer import ByteTokenizer

    args = types.SimpleNamespace(
        temperature=0.7, top_k=50, top_p=1.0, repetition_penalty=1.0,
        greedy=True, max_slots=8, page_size=PAGE, num_pages=0, max_seq=2048,
        kv_bits=16, seed=0, step_ticks=8, device="cuda")
    server = Server(cfg, params, ByteTokenizer(), None, args)
    server.engine._eos = set()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()

    try:
        t0 = time.perf_counter()
        st, body = call("POST", "/generate", {"prompt": "Hello, H100.",
                                              "max_new_tokens": 8})
        gen = json.loads(body)
        st2, raw = call("POST", "/v1/completions",
                        {"prompt": "Once upon a time", "max_tokens": 8,
                         "temperature": 0, "stream": True})
        # a data event per text delta (ids past the byte tokenizer's 260
        # decode to nothing), the finishing chunk, then [DONE]
        events = [e for e in raw.decode().split("\n\n") if e]
        finish = (json.loads(events[-2][6:])["choices"][0]["finish_reason"]
                  if len(events) >= 2 else None)
        st3, body3 = call("POST", "/v1/chat/completions",
                          {"messages": [{"role": "user", "content": "Hi"}],
                           "max_tokens": 8, "temperature": 0})
        chat = json.loads(body3)
        st4, body4 = call("GET", "/stats")
        stats = json.loads(body4)
        dt = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(timeout=30)
    print(f"[http] 127.0.0.1:{port}: /generate {st} {len(gen.get('token_ids', []))} "
          f"tokens ({gen.get('finish_reason')}) | /v1/completions stream "
          f"{st2}, {len(events)} events ({finish}), last "
          f"{events[-1] if events else None} "
          f"| /v1/chat/completions {st3} "
          f"({chat.get('choices', [{}])[0].get('finish_reason')}) | /stats "
          f"{st4}: {stats.get('requests')} requests | {dt:.2f} s", flush=True)
    if (st, st2, st3, st4) != (200, 200, 200, 200) or \
            len(gen.get("token_ids", [])) != 8 or events[-1] != "data: [DONE]" \
            or finish != "length" or stats.get("requests", 0) < 3 \
            or chat.get("choices", [{}])[0].get("finish_reason") != "length":
        fail("http: a request failed or answered wrongly")
    if thread.is_alive() or server._thread.is_alive():
        fail("http: a server thread is still running")


def paged_model_check(torch, cfg4, params4, params4_f32, prompts, swaps_plain,
                      swaps_f32, kv_dtype):
    """The 4-layer model over the page pool (pages of 512, table [3, 1]),
    bf16 or INT8: a prefill in pieces of 256 (a fresh piece, then
    continuations at 256 and at 512, the second on the table's second
    page) of a 700-token prompt, 4 decode steps there, then one verify
    forward of SPEC_T tokens; the logits of all six, kernel path vs plain
    bf16 path vs fp32 plain path (over the same int8 pool type for INT8)."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import PagedKVCache
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    q8 = kv_dtype == torch.int8
    n, pieces = 700, (0, 256, 512)
    prompt = prompts([n])[0]
    feed = prompts([4 + SPEC_T])[0]
    tables = torch.tensor([[3, 1, 0, 0]], dtype=torch.int32, device="cuda")

    def run(p, dtype):
        cache = PagedKVCache.create(cfg4.num_layers, 4, PAGE, cfg4.num_kv_heads,
                                    cfg4.head_dim, dtype=dtype, device="cuda")
        out = []
        with torch.inference_mode():
            for start in pieces:
                toks = torch.zeros((1, 256), dtype=torch.long, device="cuda")
                piece = prompt[start:start + 256]
                toks[0, :len(piece)] = torch.tensor(piece, device="cuda")
                pos = start + torch.arange(256, device="cuda")[None]
                hidden, cache = qwen.forward_hidden(
                    p, cfg4, toks, pos, cache, block_tables=tables,
                    fresh_prefill=start == 0, start=start or None)
            out.append(qwen.compute_logits(p, hidden[:, n - pieces[-1] - 1],
                                           cfg4.act_bits_lm_head))
            for i, t in enumerate(feed[:4]):
                logits, cache = qwen.decode_step(
                    p, cfg4, torch.tensor([t], device="cuda"),
                    torch.tensor([n + i], device="cuda"), cache, tables)
                out.append(logits)
            pos = n + 4 + torch.arange(SPEC_T, device="cuda")[None]
            hidden, cache = qwen.forward_hidden(
                p, cfg4, torch.tensor([feed[4:]], device="cuda"), pos, cache,
                block_tables=tables, ragged_multi=True)
            out.append(qwen.compute_logits(p, hidden[0],
                                           cfg4.act_bits_lm_head))
        return torch.cat(out, 0)

    chunk = ca.paged_chunk_attention_q8 if q8 else ca.paged_chunk_attention
    verify = (pa.paged_verify_attention_stacked_q8 if q8
              else pa.paged_verify_attention_stacked)
    before = (chunk.launches, verify.launches)
    pool = torch.int8 if q8 else torch.bfloat16
    lk = run(params4, pool)
    if (chunk.launches - before[0], verify.launches - before[1]) != \
            (2 * cfg4.num_layers, cfg4.num_layers):
        fail("the paged model check did not run its continuation pieces "
             "and its verify through their kernels")
    with Swapped(swaps_plain):
        lp = run(params4, pool)
    with Swapped(swaps_f32):
        lr = run(params4_f32, torch.int8 if q8 else torch.float32)
    model_check(f"paged {'INT8' if q8 else 'bf16'} KV, pieces at {pieces} of "
                f"a {n}-token prompt across two pages, 4 decode steps, a "
                f"verify of {SPEC_T}", lk, lp, lr)


def warm_up(eng, prompts):
    """A short call of each batch kind (aligned, then ragged) of 16-token
    prompts: each decode key's first step runs eagerly and its second is
    captured, so the timed calls after it replay."""
    B = eng.max_batch
    eng.generate(prompts([16] * B), max_new_tokens=3)
    eng.generate(prompts([16] * (B - 1) + [17]), max_new_tokens=3)


def run_formats(torch, cfg, variants, wrappers, prompts):
    """Phase 4 (a)-(d): one Engine.generate run per weight format, 32 new
    tokens.  Each run must launch only its own matmul kernels (and
    fused_mlp), and the ragged ones kv_append_ragged_t, as many per forward
    as ``want`` says (a count, or a (prefill, decode step) pair), and the
    attention kernels of its KV type.  Returns the runs' numbers."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    runs = {}
    for label, (vcfg, params, kv, lengths, want, must) in variants.items():
        eng = Engine(vcfg, params, max_batch=4, max_seq=1024, kv_dtype=kv,
                     sampling=SamplingParams(greedy=True), device="cuda")
        warm_up(eng, prompts)
        for w in wrappers.values():
            w.launches = 0
        res = eng.generate(prompts(lengths), max_new_tokens=32)
        counts = {n: w.launches for n, w in wrappers.items()}
        ids = [t for row in res.token_ids for t in row]
        print(f"[e2e] {label} {lengths}: ttft {res.ttft_s * 1e3:.1f} ms | "
              f"decode {res.decode_tokens_per_s:.1f} tok/s | steps "
              f"{res.steps} | launches {counts}", flush=True)
        print(f"      first ids {[row[:8] for row in res.token_ids]}")
        if not all(0 <= t < vcfg.vocab_size for t in ids) or len(set(ids)) < 2:
            fail(f"{label}: ids out of range or all identical")
        mm = {n: counts[n] for n in (*MATMULS, "fused_mlp",
                                     "kv_append_ragged_t")}
        per = {n: want.get(n, 0) for n in mm}
        per = {n: v if isinstance(v, tuple) else (v, v)
               for n, v in per.items()}
        expect = {n: p + (res.steps - 1) * d for n, (p, d) in per.items()}
        missing = sorted(n for n in must if counts[n] <= 0)
        if mm != expect or missing:
            fail(f"{label}: matmul launches {mm}, expected {expect} "
                 f"({res.steps} forwards); not launched {missing}")
        runs[label] = dict(lengths=lengths, ttft_ms=res.ttft_s * 1e3,
                           decode_tok_s=res.decode_tokens_per_s,
                           steps=res.steps, launches=counts)
        del eng
        torch.cuda.empty_cache()
    return runs


def run_serving_w4a16(torch, cfg, params, wrappers, rng):
    """Phase 4b on the W4A16 params: 8 requests (prompts of 37 to 1100
    tokens, 16 new tokens each) through ContinuousBatchingEngine; the
    INT4 x bf16 kernel and the four paged kernels must launch, the W4A8
    kernel must not."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, max_slots=8, page_size=PAGE, num_pages=40,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
        sampling=SamplingParams(greedy=True), device="cuda")
    cb._eos = set()
    lens = [37, 120, 300, 511, 600, 800, 1000, 1100]
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, n in enumerate(lens):
        cb.submit(Request(request_id=i, max_new_tokens=16,
                          prompt=rng.integers(0, cfg.vocab_size,
                                              size=n).tolist()))
    done = cb.run_to_completion(sync_every=8)
    cb.check_page_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    snap = cb.metrics.snapshot()
    print(f"[serve w4a16] {len(done)} requests (prompts {lens}, 16 new "
          f"tokens) in {wall:.2f} s | TTFT p50 {snap['ttft_p50_s'] * 1e3:.1f}"
          f" ms, p99 {snap['ttft_p99_s'] * 1e3:.1f} ms | decode "
          f"{snap['decode_tokens_per_s']:.1f} tok/s | launches {counts}",
          flush=True)
    if len(done) != 8 or any(f.finish_reason != "length"
                             or len(f.token_ids) != 16 for f in done):
        fail("serving w4a16: a request did not finish by length")
    # every forward has M <= 256 (pieces of 256, 8 decode slots): the MLP
    # is fused_mlp, 4 matmuls a layer
    must = {"quant_matmul4", "flash_attention", "paged_append_prefill",
            "paged_chunk_attention", "paged_append_ragged",
            "paged_decode_attention_stacked", "fused_mlp"}
    missing = sorted(n for n in must if counts[n] <= 0)
    stray = sorted(n for n in counts if n not in must and counts[n] != 0)
    if missing or stray:
        fail(f"serving w4a16: not launched {missing}, stray {stray}")
    # 4 matmuls a layer beside each fused MLP, and at most one INT4 lm_head
    # a forward (a forward is num_layers fused MLPs)
    heads = counts["quant_matmul4"] - 4 * counts["fused_mlp"]
    if not 0 <= heads <= counts["fused_mlp"] // cfg.num_layers:
        fail(f"serving w4a16: {counts['quant_matmul4']} W4A16 matmuls for "
             f"{counts['fused_mlp']} fused MLPs (4 a layer + the lm_heads "
             f"expected)")
    del cb
    torch.cuda.empty_cache()
    return counts, dict(wall_s=wall, **snap)


SPEC_K = SPEC_T - 1


def echo_prompts(rng, vocab, lengths):
    """Extraction traffic, what prompt lookup is for: a passage of n
    tokens followed by its first half again."""
    out = []
    for n in lengths:
        passage = rng.integers(0, vocab, size=n).tolist()
        out.append(passage + passage[:n // 2])
    return out


def run_serving_spec(torch, cfg, params, wrappers, rng, kv_dtype, mode,
                     draft=False, speculative=True):
    """Speculative serving at the serving defaults (8 slots, pages of 512,
    pieces of 256, prefix cache on), spec_k 4, greedy, EOS off: 8 echo
    prompts (150..1350 tokens, 32 new tokens each) by prompt lookup (spec
    ngram 3) through ``step`` (host drafts) or ``step_batch`` (chained
    rounds, 8 per sync), or with a drafter equal to the target; with
    ``speculative=False`` the same traffic by plain decode ticks (the
    yardstick).  The launch counts are set to 0 before the run and read
    after it.  Returns (counts, numbers)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    q8 = kv_dtype == torch.int8
    sfx = "_q8" if q8 else ""
    label = (f"[serve {'spec ' if speculative else 'echo '}"
             f"{'draft' if draft else 'pld' if speculative else 'plain'}"
             f"{' int8' if q8 else ''} {mode}]")
    extra = dict(draft_params=params, draft_cfg=cfg) if draft else {}
    cb = ContinuousBatchingEngine(
        cfg, params, max_slots=8, page_size=PAGE, num_pages=48,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
        sampling=SamplingParams(greedy=True), kv_dtype=kv_dtype,
        speculative=speculative, spec_k=SPEC_K, spec_ngram=3, device="cuda",
        **extra)
    cb._eos = set()
    prompts = echo_prompts(rng, cfg.vocab_size,
                           [100, 200, 300, 400, 500, 600, 700, 900])
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=NEW_TOKENS))
    if mode == "step":
        done = []
        while cb.has_work():
            done += cb.step()
    else:
        done = cb.run_to_completion(sync_every=8)
    cb.check_page_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    snap = cb.metrics.snapshot()
    print(f"{label} {len(done)} requests (echo prompts "
          f"{[len(p) for p in prompts]}, {NEW_TOKENS} new) in {wall:.2f} s | "
          f"spec rounds {snap['spec_rounds']}, tokens per forward "
          f"{snap['spec_tokens_per_forward']:.3f} | TTFT p50 "
          f"{snap['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{snap['ttft_p99_s'] * 1e3:.1f} ms | decode "
          f"{snap['decode_tokens_per_s']:.1f} tok/s | launches "
          f"{ {n: c for n, c in counts.items() if c} }", flush=True)
    if len(done) != 8 or any(f.finish_reason != "length"
                             or len(f.token_ids) != NEW_TOKENS for f in done):
        fail(f"{label}: a request did not finish by length")
    ids = [t for f in done for t in f.token_ids]
    if not all(0 <= t < cfg.vocab_size for t in ids):
        fail(f"{label}: ids out of range")
    must = {"paged_verify_attention_stacked" + sfx, "paged_append_ragged_t",
            "paged_append_prefill", "flash_attention", "quant_matmul4_a8"}
    if draft or not speculative:   # the drafter's or the plain decode
        must |= {"paged_decode_attention_stacked" + sfx,
                 "paged_append_ragged"}
    other = "" if q8 else "_q8"
    never = {"paged_verify_attention_stacked" + other,
             "paged_decode_attention_stacked" + other,
             "paged_chunk_attention" + other}
    if not speculative:
        moved = {"paged_verify_attention_stacked" + sfx,
                 "paged_append_ragged_t"}
        must -= moved
        never |= moved
    missing = sorted(n for n in must if counts[n] <= 0)
    stray = sorted(n for n in never if counts[n] != 0)
    if missing or stray or (snap["spec_rounds"] > 0) != speculative:
        fail(f"{label}: not launched {missing}, launched {stray}, spec "
             f"rounds {snap['spec_rounds']}")
    if draft and not snap["spec_tokens_per_forward"] > SPEC_K:
        fail(f"{label}: a drafter equal to the target gave "
             f"{snap['spec_tokens_per_forward']} tokens per forward, not "
             f"more than {SPEC_K}")
    del cb
    torch.cuda.empty_cache()
    return counts, dict(wall_s=wall, **snap)


def _first_part(x, y) -> int:
    """The index where two token lists first differ (their common length
    if they never do)."""
    return next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                min(len(x), len(y)))


def run_generate_spec(torch, cfg, params, wrappers, rng):
    """``Engine.generate_speculative`` (k 4, ngram 3) at batch 4 on echo
    prompts against ``Engine.generate`` greedy on the same prompts, 32 new
    tokens, at full depth.

    The verify's logits are held against the plain run's directly: every
    verify column whose inputs (the history and the drafts before it) equal
    the plain run's tokens predicts a token the plain run also predicted,
    over the same history, and the largest |dlogit| between the two must be
    at most ``tol`` = 1.5 x ``d_ref``.  ``d_ref`` is measured here: the
    largest |dlogit| between the plain run and the same run with the plain
    attention versions (two bf16 computations of the same logits at this
    depth, up to where their tokens part).  Where a row's tokens part, the
    plain run's top-two gap there must be below ``2 x tol`` (a near-tie:
    two logit vectors ``tol`` apart can pick different tokens only then)."""
    from qwen_inference_engine_tpu_torch.engine import speculative as spec_mod
    from qwen_inference_engine_tpu_torch.engine import step_graph
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    eng = Engine(cfg, params, max_batch=4, max_seq=2048,
                 sampling=SamplingParams(greedy=True), device="cuda")
    eng.cfg = cfg.replace(eos_token_ids=())   # random weights: EOS off
    prompts = echo_prompts(rng, cfg.vocab_size, [120, 200, 300, 400])
    B = len(prompts)

    def recorder(module, out_list):
        compute = module.compute_logits

        def record(*a, **k):
            out = compute(*a, **k)
            out_list.append(out.detach().clone())
            return out
        return record

    # every step's logits are recorded where Python computes them, so
    # both generate runs take the eager steps ([graph generate] holds the
    # captured steps to them bit for bit)
    steps, steps_ref, rounds = [], [], []
    with Swapped([(qwen, "compute_logits", recorder(qwen, steps))]), \
            step_graph.eager_steps():
        plain = eng.generate(prompts, max_new_tokens=NEW_TOKENS).token_ids
    with Swapped([(qwen, "compute_logits", recorder(qwen, steps_ref)),
                  *attention_swaps()]), step_graph.eager_steps():
        ref = eng.generate(prompts, max_new_tokens=NEW_TOKENS).token_ids
    d_ref = max(float((steps[i][b] - steps_ref[i][b]).abs().max())
                for b in range(B)
                for i in range(min(_first_part(plain[b], ref[b]) + 1,
                                   NEW_TOKENS)))
    del steps_ref
    forward = spec_mod.forward_hidden
    inputs = []

    def record_inputs(params_, cfg_, tokens, positions, *a, **k):
        inputs.append((tokens.clone(), positions.clone()))
        return forward(params_, cfg_, tokens, positions, *a, **k)

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Swapped([(spec_mod, "forward_hidden", record_inputs),
                  (spec_mod, "compute_logits",
                   recorder(spec_mod, rounds))]):
        spec = eng.generate_speculative(prompts, max_new_tokens=NEW_TOKENS,
                                        k=SPEC_K, ngram=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    part = [_first_part(p, s_) for p, s_ in zip(plain, spec)]
    d_spec, n_cmp = 0.0, 0
    for (tokens, positions), logits in zip(inputs, rounds):
        tokens, positions = tokens.tolist(), positions.tolist()
        for b in range(B):
            for j in range(SPEC_K + 1):
                i = positions[b][j] + 1 - len(prompts[b])  # token it predicts
                if not i < NEW_TOKENS or i - j > part[b] \
                        or tokens[b][1:j + 1] != plain[b][i - j:i]:
                    continue
                d_spec = max(d_spec, float(
                    (logits[b, j] - steps[i][b]).abs().max()))
                n_cmp += 1
    tol = 1.5 * d_ref
    rows = []
    for b, (p, s_) in enumerate(zip(plain, spec)):
        if part[b] >= min(len(p), len(s_)):
            rows.append((len(s_), None))
            continue
        top = steps[part[b]][b].topk(2).values
        rows.append((part[b], float(top[0] - top[1])))
    print(f"[generate spec] batch {B}, echo prompts {[len(p) for p in prompts]}"
          f", {NEW_TOKENS} new, k {SPEC_K}: {wall:.2f} s | verify logits vs "
          f"generate's over the same inputs: max |dlogit| {d_spec:.4g} over "
          f"{n_cmp} positions (tol 1.5 x d_ref = {tol:.4g}; d_ref {d_ref:.4g}"
          f" = generate vs generate with plain attention) | rows (tokens "
          f"equal, plain top-2 gap where they part; near-tie < 2 x tol) "
          f"{rows} | continuation chunks "
          f"{counts['chunk_attention_contiguous']}", flush=True)
    bad = [r for r in rows if r[1] is not None and not r[1] < 2 * tol]
    covered = sum(min(n, NEW_TOKENS - 1) for n in part)
    # each verify forward writes its windows with one kv_append_ragged_t a
    # layer
    want_rag = cfg.num_layers * len(inputs)
    print(f"      kv_append_ragged_t launches {counts['kv_append_ragged_t']} "
          f"over {len(inputs)} verify forwards (want {want_rag})", flush=True)
    if counts["kv_append_ragged_t"] != want_rag or not inputs:
        fail(f"[generate spec] {counts['kv_append_ragged_t']} "
             f"kv_append_ragged_t launches over {len(inputs)} verify "
             f"forwards, want {want_rag}")
    if bad or not d_spec <= tol or n_cmp < covered or \
            counts["chunk_attention_contiguous"] <= 0 or \
            any(len(x) != NEW_TOKENS for x in spec):
        fail(f"[generate spec] verify logits {d_spec} from generate's (tol "
             f"{tol}) over {n_cmp} positions (at least {covered}), parts away"
             f" from a near-tie {bad}, or the verify never ran")
    del eng, steps, rounds
    torch.cuda.empty_cache()
    return counts, dict(wall_s=wall, rows=rows, max_abs_dlogit=d_spec,
                        d_ref=d_ref, tol=tol, positions_compared=n_cmp)


def hf_state_dict(cfg, params) -> dict:
    """The HF names of the port's params (projections back to [out, in]; a
    Qwen3-MoE model's router ``mlp.gate`` and ``mlp.experts.{e}.*``)."""
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"]}
    lyr = params["layers"]
    proj = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
            "v": "self_attn.v_proj", "o": "self_attn.o_proj",
            "gate": "mlp.gate_proj", "up": "mlp.up_proj",
            "down": "mlp.down_proj"}
    if cfg.is_moe:
        proj = {key: hf for key, hf in proj.items()
                if key not in ("gate", "up", "down")}
        proj["router"] = "mlp.gate"
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = lyr["input_norm"][i]
        sd[p + "post_attention_layernorm.weight"] = lyr["post_norm"][i]
        for key, hf in proj.items():
            sd[p + hf + ".weight"] = lyr[key].w[i].t()
            if lyr[key].b is not None:
                sd[p + hf + ".bias"] = lyr[key].b[i]
        for e in range(cfg.num_experts):
            for key, hf in (("moe_gate", "gate_proj"), ("moe_up", "up_proj"),
                            ("moe_down", "down_proj")):
                sd[p + f"mlp.experts.{e}.{hf}.weight"] = lyr[key][i, e].t()
        if cfg.qk_norm:
            sd[p + "self_attn.q_norm.weight"] = lyr["q_norm"][i]
            sd[p + "self_attn.k_norm.weight"] = lyr["k_norm"][i]
    if "lm_head" in params:
        sd["lm_head.weight"] = params["lm_head"].w.t()
    return sd


def _cli_ids(torch, argv):
    """Run the port's CLI; return its generated ids and stdout."""
    import contextlib
    import io

    from qwen_inference_engine_tpu_torch.server import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    if rc != 0:
        fail(f"cli {argv[:3]} returned {rc}")
    return [json.loads(lines[i + 1]) for i, line in enumerate(lines)
            if line.startswith("--- sequence")]


def cli_serve_spec_int8(torch, ckpt):
    """``qie serve --ckpt CKPT --bits 4 --kv-bits 8 --speculative`` through
    the CLI on 127.0.0.1 (an ephemeral port): one /generate and /stats,
    then the server is shut down as a KeyboardInterrupt would."""
    import http.client
    import threading

    from qwen_inference_engine_tpu_torch.server import cli
    from qwen_inference_engine_tpu_torch.server import http as thttp

    held = {}
    base = thttp.ThreadingHTTPServer

    class Held(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            held["httpd"] = self

    argv = ["serve", "--ckpt", ckpt, "--bits", "4", "--kv-bits", "8",
            "--speculative", "--spec-k", "4", "--spec-ngram", "3",
            "--max-seq", "512", "--max-slots", "2", "--greedy",
            "--host", "127.0.0.1", "--port", "0"]
    thttp.ThreadingHTTPServer = Held
    try:
        thread = threading.Thread(
            target=lambda: held.__setitem__("rc", cli.main(argv)), daemon=True)
        thread.start()
        t0 = time.perf_counter()
        while "httpd" not in held and thread.is_alive() and \
                time.perf_counter() - t0 < 300:
            time.sleep(0.1)
    finally:
        thttp.ThreadingHTTPServer = base
    if "httpd" not in held:
        fail("cli serve: the server never bound")
    port = held["httpd"].server_address[1]

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())

    try:
        st, gen = call("POST", "/generate",
                       {"prompt": "the pages, the pages, the pages, the",
                        "max_new_tokens": 12})
        st2, stats = call("GET", "/stats")
    finally:
        held["httpd"].shutdown()
        thread.join(timeout=60)
    print(f"[cli serve] serve --ckpt (2 layers) --bits 4 --kv-bits 8 "
          f"--speculative on 127.0.0.1:{port}: /generate {st} "
          f"{len(gen.get('token_ids', []))} tokens ({gen.get('finish_reason')})"
          f" | /stats {st2}: spec rounds {stats.get('spec_rounds')} | exit "
          f"{held.get('rc')}", flush=True)
    if (st, st2) != (200, 200) or not gen.get("token_ids") \
            or thread.is_alive() or held.get("rc") != 0:
        fail("cli serve --speculative --kv-bits 8: a request failed or the "
             "server did not stop")
    return {"cli_serve_spec_rounds": stats.get("spec_rounds")}


def run_loader_phase(torch, cfg, bf16_params):
    """A 2-layer checkpoint at the Qwen2.5-7B widths in HF layout (two BF16
    shards, an index, q/k/v biases, an untied lm_head), taken from the
    seeded params and written into a temporary directory that is deleted
    afterwards; then load_checkpoint, the ``quantize`` command,
    load_quantized and ``generate`` from both checkpoints, each weight
    format, all on the card."""
    import tempfile

    from qwen_inference_engine_tpu_torch.loader.qcheckpoint import (
        load_quantized,
    )
    from qwen_inference_engine_tpu_torch.loader.safetensors_loader import (
        load_checkpoint,
    )
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    cfg2 = cfg.replace(num_layers=2)
    src = dict(bf16_params, layers=qwen.map_params(bf16_params["layers"],
                                                   lambda t: t[:2]))
    sd = hf_state_dict(cfg2, src)
    n_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    out = {}
    with tempfile.TemporaryDirectory(prefix="qie_smoke_") as tmp:
        d, q = os.path.join(tmp, "hf"), os.path.join(tmp, "q")
        t0 = time.perf_counter()
        write_hf_checkpoint(d, cfg2.to_hf_config(), sd, shards=2)
        out["write_s"] = time.perf_counter() - t0
        shards = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcfg, loaded = load_checkpoint(d)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        got = hf_state_dict(lcfg, loaded)
        bad = sorted(n for n, t in sd.items()
                     if not (got[n].is_cuda and torch.equal(got[n], t)))
        print(f"[loader] {cfg2.name} widths, 2 layers: {len(sd)} tensors, "
              f"{n_bytes / 1e9:.3f} GB in {len(shards)} BF16 shards, written "
              f"in {out['write_s']:.2f} s; load_checkpoint on the card "
              f"{out['load_s']:.2f} s ({n_bytes / out['load_s'] / 1e9:.2f} "
              f"GB/s), {len(bad)} tensors differ", flush=True)
        if len(shards) < 2 or bad or set(got) != set(sd):
            fail(f"loader: {len(shards)} shards, tensors differ {bad[:4]}")
        t0 = time.perf_counter()
        _cli_ids(torch, ["quantize", "--ckpt", d, "--bits", "4",
                         "--group-size", "128", "--out", q])
        out["quantize_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        qcfg, qp = load_quantized(q)
        torch.cuda.synchronize()
        out["load_quantized_s"] = time.perf_counter() - t0
        q_bytes = sum(os.path.getsize(os.path.join(q, f)) for f in os.listdir(q))
        want = quantize_params(loaded, QuantConfig(bits=4, group_size=128))
        diff = sorted(n for n in ("q", "k", "v", "o", "gate", "up", "down")
                      if not (torch.equal(qp["layers"][n].q, want["layers"][n].q)
                              and torch.equal(qp["layers"][n].scales,
                                              want["layers"][n].scales)))
        print(f"[loader] quantize --bits 4 --group-size 128: {out['quantize_s']:.2f}"
              f" s (load, quantize, write {q_bytes / 1e9:.3f} GB); "
              f"load_quantized {out['load_quantized_s']:.2f} s "
              f"({q_bytes / out['load_quantized_s'] / 1e9:.2f} GB/s); q and "
              f"scales differ from quantize_params of the loaded params in "
              f"{diff}", flush=True)
        if diff or qcfg.num_layers != 2:
            fail(f"loader: quantized checkpoint differs in {diff}")
        del loaded, got, want, qp
        torch.cuda.empty_cache()
        gen = ["--prompt", "Hello, H100.", "--prompt", "The weights are",
               "--max-new-tokens", "8", "--greedy", "--max-seq", "256"]
        ids = {"--qckpt": _cli_ids(torch, ["generate", "--qckpt", q, *gen]),
               "--ckpt --bits 4": _cli_ids(torch, ["generate", "--ckpt", d,
                                                   "--bits", "4", *gen])}
        for fmt in (["--bits", "8"], ["--bits", "8", "--act-bits", "8"],
                    ["--bits", "4", "--act-bits", "8"], ["--bits", "16"]):
            ids["--ckpt " + " ".join(fmt)] = _cli_ids(
                torch, ["generate", "--ckpt", d, *fmt, *gen])
        spec = _cli_ids(torch, ["generate", "--ckpt", d, "--bits", "4", *gen,
                                "--speculative", "--spec-k", "4"])
        print(f"[loader] generate: {ids} | --ckpt --bits 4 --speculative "
              f"{spec} (equal to --ckpt --bits 4: "
              f"{spec == ids['--ckpt --bits 4']})", flush=True)
        if ids["--qckpt"] != ids["--ckpt --bits 4"] or any(
                len(v) != 2 or not all(len(r) >= 1 for r in v)
                for v in list(ids.values()) + [spec]):
            fail("loader: generate --qckpt and --ckpt --bits 4 differ, or a "
                 "format generated nothing")
        out.update(cli_serve_spec_int8(torch, d))
        out["cli_utils"] = run_cli_utils(torch, d)
    out["bytes"] = n_bytes
    out["load_gb_s"] = n_bytes / out["load_s"] / 1e9
    return out


# ----------------------------------------------------------------------
# Qwen3-MoE: the grouped kernels (phase 3) and the MoE model (phase 6)
# ----------------------------------------------------------------------

# the three grouped kernels: (weight bits, activation bits, peak type)
GROUPED = {"grouped_matmul4_a8": (4, 8, "int8"),
           "grouped_matmul4": (4, 0, "bf16"),
           "grouped_matmul8": (8, 0, "bf16")}
# of the largest output: the plain versions dequantize to bf16 weights (a
# relative 2^-9 each) where the kernels scale in f32 (the dense rule)
GROUPED_TOL = 2 ** -6
MOE_DECODE_TOKENS = 32     # batch 32 x top-8 = 256 rows
MOE_PIECE_TOKENS = 512     # a 512-token prefill piece: 4096 rows
MOE_TTFT_TOKENS = 32 * 512  # [moe generate]'s prefill, batch 32 x 512:
                            # 131072 rows a layer


def _routing(torch, g, n_tokens, E, k):
    """Expert sizes of ``n_tokens`` tokens' top-k of random logits."""
    ids = torch.rand((n_tokens, E), generator=g, device="cuda").topk(
        k, dim=-1).indices
    return torch.bincount(ids.reshape(-1), minlength=E).to(torch.int32)


def _grouped_library(torch, x, w, gsz):
    """The yardstick: bf16 ``torch._grouped_mm`` over the dequantized layer
    slab ``w [E, K, N]``, where this torch has it and takes the shapes;
    else one ``torch.matmul`` per expert (the sizes read on the host).
    Returns (fn, label)."""
    offs = torch.cumsum(gsz, 0).to(torch.int32)
    wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
    if hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(x, wt, offs=offs)
            return (lambda: torch._grouped_mm(x, wt, offs=offs),
                    "torch._grouped_mm bf16")
        except (RuntimeError, TypeError) as exc:  # yardstick only
            print(f"  (torch._grouped_mm refused: {str(exc)[:120]})")
    sizes = gsz.tolist()

    def loop():
        start = 0
        for e, n in enumerate(sizes):
            if n:
                torch.matmul(x[start:start + n], w[e])
            start += n

    return loop, "per-expert torch.matmul bf16"


def check_grouped_matmul(torch, cfg):
    """The three grouped kernels against their plain versions at the
    Qwen3-30B-A3B expert shapes (gate/up K = 2048, N = 768, INT4 gs 256;
    down K = 768, N = 2048, INT4 gs 128; INT8 per group of 128 rows and per
    column), layer 1 of a stacked [2, 128, ...] tensor with random scales:
    M = 256 (decode, batch 32 x top-8; grouped_matmul8 and its yardstick
    also in a CUDA graph) and M = 4096 (a 512-token piece) routed by random
    top-8 (each kernel and its yardstick also in a CUDA graph at M = 256),
    the edge sizes of the JAX package's tests at M = 300 (empty experts,
    one expert taking every row, every tile straddling; the INT4 kernels
    over the one expert bit-equal to the dense kernel over its slab), and
    each kernel at [moe generate]'s prefill of batch 32 x 512, M = 131072.
    Returns {kernel: [records]}."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, dequantize
    from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
        quantize_activations,
    )

    E, k = cfg.num_experts, cfg.num_experts_per_tok
    D, Fm = cfg.hidden_size, cfg.moe_intermediate_size
    g = torch.Generator(device="cuda").manual_seed(12)
    L, layer = 2, 1

    def pad(sizes):
        return torch.tensor(sizes + [0] * (E - len(sizes)), dtype=torch.int32,
                            device="cuda")

    # (label, group sizes, "timed" / "edge" (checked only) / "ttft" (timed,
    # no per-column INT8 scales))
    cases = [(f"M={MOE_DECODE_TOKENS * k} decode",
              _routing(torch, g, MOE_DECODE_TOKENS, E, k), "timed"),
             (f"M={MOE_PIECE_TOKENS * k} prefill piece",
              _routing(torch, g, MOE_PIECE_TOKENS, E, k), "timed"),
             ("M=300 empties", pad([0, 200, 7, 0, 93]), "edge"),
             ("M=300 one expert", pad([300]), "edge"),
             ("M=300 every tile straddling", pad([37, 61, 64, 70, 68]), "edge"),
             (f"M={MOE_TTFT_TOKENS * k} prefill of batch 32 x 512",
              _routing(torch, g, MOE_TTFT_TOKENS, E, k), "ttft")]
    records = {n: [] for n in GROUPED}
    for proj, K, N, gs4 in (("gate", D, Fm, 256), ("down", Fm, D, 128)):
        weights = {
            4: (torch.randint(-128, 128, (L, E, K // 2, N), generator=g,
                              device="cuda", dtype=torch.int8),
                torch.rand((L, E, K // gs4, N), generator=g, device="cuda")
                * (2 * K ** -0.5 / 7), gs4),
            8: (torch.randint(-127, 128, (L, E, K, N), generator=g,
                              device="cuda", dtype=torch.int8),
                torch.rand((L, E, K // 128, N), generator=g, device="cuda")
                * (2 * K ** -0.5 / 127), 128)}
        s8_col = torch.rand((L, E, 1, N), generator=g, device="cuda") \
            * (2 * K ** -0.5 / 127)
        for label, gsz, mode in cases:
            M = int(gsz.sum())
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            xq, sx = quantize_activations(x)
            sx = sx.reshape(-1).contiguous()
            touched = int((gsz > 0).sum())
            for name, (bits, act_bits, peak) in GROUPED.items():
                q, s, gs = weights[bits]
                for scales, tag in ((s, f"gs {gs}"), (s8_col, "per column")):
                    if tag == "per column" and (bits == 4 or mode == "ttft"):
                        continue
                    fn, plain = getattr(gm, name), getattr(gm, name + "_plain")
                    if act_bits:
                        args = (xq, sx, q, scales, gsz, layer, gs)
                    elif bits == 4:
                        args = (x, q, scales, gsz, layer, gs)
                    else:
                        args = (x, q, scales, gsz, layer)
                    got = fn(*args)
                    ref = plain(*args)
                    torch.cuda.synchronize()
                    err = (got.float() - ref.float()).abs().max().item()
                    tol = GROUPED_TOL * ref.float().abs().max().item()
                    shape = (f"{cfg.name} {proj} {label} K={K} N={N} {tag} "
                             f"experts touched {touched}")
                    if not (err <= tol and bool(got.isfinite().all())):
                        fail(f"{name} {shape}: err {err} > {tol} or non-finite")
                    del ref
                    if mode == "edge":
                        same = ""
                        if bits == 4 and int((gsz > 0).sum()) == 1:
                            same = f" | {dense_equal(torch, qm, got, args)}"
                        print(f"  {name} {shape}: err {err:.3g} (tol "
                              f"{tol:.3g}){same}", flush=True)
                        continue
                    ms = time_ms(torch, lambda: fn(*args))
                    plain_ms = time_ms(torch, lambda: plain(*args), iters=3,
                                       warmup=1)
                    w = dequantize(QuantLinear(q=q[layer], scales=scales[layer],
                                               b=None, bits=bits,
                                               group_size=gs))
                    lib, lib_label = _grouped_library(torch, x, w, gsz)
                    lib_ms = time_ms(torch, lib)
                    graphs = {}
                    if M == MOE_DECODE_TOKENS * k:
                        graphs = dict(graph_ms=graph_ms(torch, lambda: fn(*args)),
                                      library_graph_ms=graph_ms(torch, lib))
                    del w
                    rows = K // 2 if bits == 4 else K
                    n_bytes = (touched * (rows * N + 4 * scales.shape[2] * N)
                               + M * K * (1 if act_bits else 2)
                               + 4 * M * (act_bits > 0) + 2 * M * N + 4 * E)
                    b_ms, b_by = bound(n_bytes, 2 * M * K * N, peak)
                    in_graph = "".join(
                        f" | {key} {val:.4f}" for key, val in graphs.items())
                    print(f"  {name} {shape}: err {err:.3g} (tol {tol:.3g}) | "
                          f"kernel {ms:.4f} ms | plain {plain_ms:.4f} | "
                          f"{lib_label} {lib_ms:.4f}{in_graph} | bound "
                          f"{b_ms:.4f} ({b_by})", flush=True)
                    records[name].append(dict(
                        shape=shape, proj=proj, M=M, tag=tag, max_abs_err=err,
                        tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        library=lib_label, bound_ms=b_ms, bound_by=b_by,
                        **graphs))
            del x, xq, sx
        del weights, s8_col
        torch.cuda.empty_cache()
    return records


def dense_equal(torch, qm, got, args):
    """An INT4 grouped call whose rows all belong to one expert against the
    dense kernel (quant_matmul4_a8 / quant_matmul4) over that expert's
    slab: both run qmm_mma_body of the same kind in the same K order, with
    one K slice at M > 64, so they must agree bit for bit."""
    a8 = len(args) == 7
    x, q, scales, gsz, layer, gs = (args[0],) + args[-5:]
    e = int(torch.nonzero(gsz).flatten()[0])
    slab = (q[layer, e][None], scales[layer, e][None])
    want = (qm.quant_matmul4_a8(x, args[1], *slab, 0, gs) if a8
            else qm.quant_matmul4(x, *slab, 0, gs))
    differ = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    if x.shape[0] <= 64 or differ:
        fail(f"grouped INT4 over expert {e} ({x.shape[0]} rows) vs the "
             f"dense kernel over its slab: {differ} elements differ")
    return f"bit-equal to the dense kernel over expert {e}'s slab"


def moe_layer_record(recs):
    """A grouped kernel's JSON entry: one 30B-A3B layer's three expert
    matmuls (gate and up of one shape, down) at the decode shape, summed
    (INT8: the per-group scales; the per-column ones are in the records)."""
    dec = {r["proj"]: r for r in recs if r["M"] == MOE_DECODE_TOKENS * 8
           and r["tag"] != "per column"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "graph_ms",
            "library_graph_ms")
    out = {key: 2 * dec["gate"][key] + dec["down"][key] for key in keys
           if key in dec["gate"]}
    prefill = {r["proj"]: r for r in recs if r["M"] == MOE_TTFT_TOKENS * 8}
    if prefill:  # at [moe generate]'s prefill
        out["at_M131072"] = prefill
    out.update(max_abs_err=max(r["max_abs_err"] for r in recs),
               bound_by=dec["down"]["bound_by"],
               shape=(f"qwen3-30b-a3b decode M=256, a layer's gate + up + "
                      f"down (library: {dec['down']['library']})"))
    return out


def check_wide_window_append(torch, cfg):
    """The verify window wider than its page: T = 9 over pages of 8
    (windows spanning two and three pages, a skipped row), bf16 and int8,
    bit-exact against the plain write."""
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

    Hk, D, page, T, max_pages = cfg.num_kv_heads, cfg.head_dim, 8, 9, 8
    g = torch.Generator(device="cuda").manual_seed(14)
    starts_list = [0, 3, 7, 8, 15, -1, 20, 30]
    B = len(starts_list)
    P = B * max_pages + 2
    tables = (torch.randperm(P - 1, generator=g, device="cuda")[:B * max_pages]
              + 1).reshape(B, max_pages).to(torch.int32)
    starts = torch.tensor(starts_list, device="cuda", dtype=torch.int32)
    k = torch.randn((2, P, Hk, page, D), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((2, P, Hk, page, D), generator=g, device="cuda").to(torch.bfloat16)
    kn = torch.randn((B, T, Hk, D), generator=g, device="cuda").to(torch.bfloat16)
    vn = torch.randn((B, T, Hk, D), generator=g, device="cuda").to(torch.bfloat16)
    for quant in (False, True):
        if quant:
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            (kq, ksn), (vq, vsn) = quantize_kv(kn), quantize_kv(vn)
            base, new = [k8, v8, ks, vs], (kq, vq)
            extra = dict(ks_new=ksn, vs_new=vsn)
        else:
            base, new, extra = [k, v], (kn, vn), {}
        mine = [t.clone() for t in base]
        theirs = [t.clone() for t in base]

        def kw(st):
            return dict(extra, k_scale=st[2], v_scale=st[3]) if quant else {}

        ka.paged_append_ragged_t(mine[0], mine[1], *new, starts, tables, 1,
                                 page_size=page, **kw(mine))
        ka.paged_append_ragged_t_plain(theirs[0], theirs[1], *new, starts,
                                       tables, 1, page, **kw(theirs))
        torch.cuda.synchronize()
        diff = sum(int((a != b).sum()) for a, b in zip(mine, theirs))
        written = int((mine[0] != base[0]).any(dim=-1).sum())
        print(f"  paged_append_ragged_t {'int8' if quant else 'bf16'} T={T} > "
              f"page {page}, starts {starts_list}: {diff} elements differ "
              f"(must be 0; {written} K rows written, want "
              f"{(B - 1) * T * Hk})", flush=True)
        if diff or written != (B - 1) * T * Hk:
            fail(f"paged_append_ragged_t T={T} > page {page}: {diff} differ, "
                 f"{written} rows written")


def grouped_f32(torch):
    """An fp32 reference for the expert matmuls: per expert the exact
    dequant matmul of ops/linear.py (int8 activations where the model asks
    for them), in place of ``grouped_quant_matmul``."""
    from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, quant_matmul

    def grouped(xs, qe, group_sizes, layer=None, act_bits=0):
        out = torch.zeros((xs.shape[0], qe.out_features), device=xs.device)
        start = 0
        for e, n in enumerate(group_sizes.tolist()):
            if n:
                one = QuantLinear(q=qe.q[layer, e], scales=qe.scales[layer, e],
                                  b=None, bits=qe.bits,
                                  group_size=qe.group_size)
                out[start:start + n] = quant_matmul(
                    xs[start:start + n].float(), one, act_bits=act_bits)
            start += n
        return out.to(xs.dtype)

    return grouped


def moe_params(torch, cfg, bits, gs, layers):
    """Random packed Qwen3-MoE params at full width and ``layers`` depth,
    drawn on the card one expert slab at a time."""
    from qwen_inference_engine_tpu_torch.models import qwen

    gen = torch.Generator(device="cuda").manual_seed(21 + bits + layers)
    return qwen.init_quantized_params(cfg.replace(num_layers=layers), gen,
                                      bits=bits, group_size=gs, device="cuda")


def run_moe_generate(torch, cfg, params, wrappers, prompts, kv_dtype, kern,
                     new_tokens, label, profile=False):
    """``Engine.generate`` of a batch of 32 512-token prompts; the run must
    launch ``kern`` 3 times a layer a forward and no other grouped kernel,
    and its dense projections' kernel 4 times (q, k, v, o).  ``profile``:
    then 4 eager ``decode_step`` calls under ``torch.profiler``, and the
    batch's [graph generate] case."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    L = cfg.num_layers
    eng = Engine(cfg, params, max_batch=32, max_seq=512 + 64,
                 kv_dtype=kv_dtype, sampling=SamplingParams(greedy=True),
                 device="cuda")
    eng.generate(prompts(32, 16), max_new_tokens=3)   # warm-up, capture
    batch = prompts(32, 512)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    res = eng.generate(batch, max_new_tokens=new_tokens)
    counts = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dense = "quant_matmul4_a8" if cfg.act_bits else (
        "quant_matmul4" if kern == "grouped_matmul4" else "quant_matmul8")
    print(f"[moe generate] {label}: {cfg.name} {L} layers, batch 32 x 512 "
          f"tokens, {new_tokens} new | ttft {res.ttft_s * 1e3:.1f} ms | decode "
          f"{res.decode_tokens_per_s:.1f} tok/s | forwards {res.steps} | peak "
          f"device memory {peak:.2f} GiB | {kern} launches {counts[kern]} "
          f"({counts[kern] / res.steps:.0f} per forward, want {3 * L}) | "
          f"launches { {n: c for n, c in counts.items() if c} }", flush=True)
    ids = [t for row in res.token_ids for t in row]
    if not all(0 <= t < cfg.vocab_size for t in ids) or len(set(ids)) < 2:
        fail(f"[moe generate] {label}: ids out of range or all identical")
    numbers = profile_moe_decode(torch, eng, batch, label) if profile else {}
    if profile:
        numbers["graph"] = graph_generate_case(
            torch, eng, batch, f"{cfg.name} {L} layers, {label}", wrappers)
    stray = sorted(n for n in GROUPED if n != kern and counts[n])
    if counts[kern] != 3 * L * res.steps or stray \
            or counts[dense] != 4 * L * res.steps:
        fail(f"[moe generate] {label}: {counts[kern]} {kern} launches, want "
             f"{3 * L * res.steps}; {counts[dense]} {dense}, want "
             f"{4 * L * res.steps}; other grouped kernels launched {stray}")
    del eng
    torch.cuda.empty_cache()
    return counts, dict(layers=L, ttft_ms=res.ttft_s * 1e3,
                        decode_tok_s=res.decode_tokens_per_s,
                        forwards=res.steps, peak_gib=peak,
                        per_forward=counts[kern] / res.steps, **numbers)


def profile_moe_decode(torch, eng, batch, label, steps=4):
    """Where an MoE decode step's time goes: the batch's prefill, then
    ``steps`` uniform decode steps timed by the host clock and under
    ``torch.profiler`` (device busy time, kernel launches, kernels by
    device time)."""
    from torch.profiler import ProfilerActivity, profile

    from qwen_inference_engine_tpu_torch.models import qwen

    cfg, dev = eng.cfg, eng.device
    toks = torch.tensor(batch, device=dev)
    lens = torch.full((len(batch),), toks.shape[1], device=dev)
    with torch.inference_mode():
        logits, cache = qwen.prefill_chunked(eng.params, cfg, toks, lens,
                                             eng.new_cache(), chunk=512)
        tok = logits.argmax(-1)

        def decode(first):
            nonlocal tok, cache
            for s in range(steps):
                logits, cache = qwen.decode_step(eng.params, cfg, tok,
                                                 lens + first + s, cache,
                                                 uniform_decode=True)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()

        decode(0)
        t0 = time.perf_counter()
        decode(steps)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode(2 * steps)
    rows = device_rows(torch, prof)
    busy_ms = sum(ms for _, ms, _ in rows) / steps
    n_kernels = sum(n for _, _, n in rows) / steps
    top = sorted(rows, key=lambda r: -r[1])[:6]
    print(f"[moe generate profile] {label}: a decode step at batch "
          f"{len(batch)}: {wall_ms:.2f} ms on the host clock, device busy "
          f"{busy_ms:.2f} ms (busy share {busy_ms / wall_ms:.3f}), "
          f"{n_kernels:.0f} device kernels | by device time over {steps} "
          f"steps: " + "; ".join(f"{k[:50]} {ms:.2f} ms x{n}"
                                 for k, ms, n in top), flush=True)
    if busy_ms <= 0:
        fail("moe decode profile: the profiler saw no device time")
    return dict(step_ms=wall_ms, step_device_busy_ms=busy_ms,
                step_kernels=n_kernels)


def run_moe_serving(torch, cfg, params, wrappers, rng, kv_dtype, spec):
    """``ContinuousBatchingEngine`` with the MoE model (8 slots, pages of
    512, pieces of 256, prefix cache on, EOS off, 32 new tokens): 4
    prompts, then 4 that share a 600-token prefix with a finished one; or,
    with ``spec``, 8 echo prompts by prompt lookup (spec_k 4, ngram 3)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    q8 = kv_dtype == torch.int8
    sfx = "_q8" if q8 else ""
    label = f"[moe serve{' int8' if q8 else ''}{' pld' if spec else ''}]"
    cb = ContinuousBatchingEngine(
        cfg, params, max_slots=8, page_size=PAGE, num_pages=40,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
        sampling=SamplingParams(greedy=True), kv_dtype=kv_dtype,
        speculative=spec, spec_k=SPEC_K, spec_ngram=3, device="cuda")
    cb._eos = set()
    if spec:
        waves = [echo_prompts(rng, cfg.vocab_size,
                              [100, 200, 300, 400, 500, 600, 700, 900])]
    else:
        first = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                 for n in (300, 700, 1100, 900)]
        waves = [first, [first[2][:600] + rng.integers(
            0, cfg.vocab_size, size=n).tolist() for n in (50, 200, 400, 100)]]
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = []
    for wave, prompts in enumerate(waves):
        for i, p in enumerate(prompts):
            cb.submit(Request(request_id=100 * wave + i, prompt=p,
                              max_new_tokens=NEW_TOKENS))
        done += cb.run_to_completion(sync_every=8)
        cb.check_page_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    snap = cb.metrics.snapshot()
    print(f"{label} {cfg.name} {cfg.num_layers} layers, 8 slots: {len(done)} "
          f"requests ({[len(p) for w in waves for p in w]} tokens) in "
          f"{wall:.2f} s | TTFT p50 {snap['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{snap['ttft_p99_s'] * 1e3:.1f} ms | decode "
          f"{snap['decode_tokens_per_s']:.1f} tok/s | prefix hits "
          f"{snap['prefix_hit_tokens']} tokens | tokens per forward "
          f"{snap['spec_tokens_per_forward']:.3f} | launches "
          f"{ {n: c for n, c in counts.items() if c} }", flush=True)
    if len(done) != 8 or any(f.finish_reason != "length"
                             or len(f.token_ids) != NEW_TOKENS for f in done):
        fail(f"{label}: a request did not finish by length")
    must = {"grouped_matmul4_a8", "quant_matmul4_a8", "flash_attention",
            "paged_append_prefill"}
    must |= ({"paged_verify_attention_stacked" + sfx, "paged_append_ragged_t"}
             if spec else {"paged_decode_attention_stacked" + sfx,
                           "paged_append_ragged", "paged_chunk_attention" + sfx})
    missing = sorted(n for n in must if counts[n] <= 0)
    stray = sorted(n for n in GROUPED if n not in must and counts[n])
    if missing or stray or (snap["spec_rounds"] > 0) != spec or (
            not spec and snap["prefix_hit_tokens"] < 4 * PAGE):
        fail(f"{label}: not launched {missing}, stray {stray}, spec rounds "
             f"{snap['spec_rounds']}, prefix hits {snap['prefix_hit_tokens']}")
    window = ({} if spec or q8 else
              profile_decode_window(torch, cb, cfg, rng, label=label))
    del cb
    torch.cuda.empty_cache()
    return counts, dict(wall_s=wall, **snap, **window)


class PinnedRouting:
    """``torch.topk`` (called only by ``moe_mlp`` in a prefill) recorded in
    one run and replayed, call by call, in the next: each later run routes
    every token to the recorded experts, with its own router weights for
    them, and counts the top-k choices its own logits would have changed.
    A near-tie between two experts then flips no choice, so the logits
    rule measures arithmetic, not which side of a tie a rounding fell."""

    def __init__(self, torch):
        self.torch, self.topk, self.routes = torch, torch.topk, []
        self.flips = 0

    def record(self, x, k, dim=-1, **kw):
        out = self.topk(x, k, dim=dim, **kw)
        self.routes.append(out[1])
        return out

    def replay(self, x, k, dim=-1, **kw):
        idx = self.routes[self.calls]
        self.calls += 1
        own = self.topk(x, k, dim=dim, **kw)[1]
        self.flips += int((own.sort(dim).values != idx.sort(dim).values)
                          .any(dim).sum())
        return x.gather(dim, idx), idx

    def swaps(self, replay: bool):
        self.calls, self.flips = 0, 0
        return [(self.torch, "topk", self.replay if replay else self.record)]


def moe_model_check(torch, cfg, params, prompts, label):
    """Phase 5 for the MoE model at 4 layers: prefill logits (one chunk,
    bf16 KV) on the kernel path no further from an fp32 run of the plain
    path than 1.5x the plain bf16 path's distance, both bf16 runs routed
    as the fp32 run routes (``PinnedRouting``)."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models import qwen

    L4 = 4
    c4 = cfg.replace(num_layers=L4)
    p4 = dict(params, layers=qwen.map_params(params["layers"],
                                             lambda t: t[:L4]))
    p_lens = [37, 120, 300, 500]
    toks = torch.zeros((4, 512), dtype=torch.long, device="cuda")
    for i, p in enumerate(prompts(4, p_lens)):
        toks[i, :len(p)] = torch.tensor(p, device="cuda")
    lens = torch.tensor(p_lens, device="cuda")

    def run(p, dtype):
        cache = KVCache.create(L4, 4, 1024, cfg.num_kv_heads, cfg.head_dim,
                               dtype=dtype, device="cuda")
        with torch.inference_mode():
            return qwen.prefill_chunked(p, c4, toks, lens, cache, chunk=512)[0]

    pin = PinnedRouting(torch)
    with Swapped(f32_swaps() + pin.swaps(replay=False)):
        lr = run(qwen.map_params(p4, lambda t: t.float()
                                 if t.is_floating_point() else t),
                 torch.float32)
    with Swapped(pin.swaps(replay=True)):
        lk = run(p4, torch.bfloat16)
    flips_k = pin.flips
    with Swapped(plain_swaps() + pin.swaps(replay=True)):
        lp = run(p4, torch.bfloat16)
    model_check(f"qwen3-30b-a3b width, {label}, bf16 KV, one chunk", lk, lp,
                lr, extra=(f" | routing pinned to the fp32 run's: unpinned, "
                           f"{flips_k} (kernels) and {pin.flips} (plain) of "
                           f"{4 * 512 * L4} token-layer top-"
                           f"{cfg.num_experts_per_tok} choices would differ"))


def run_moe_phases(torch, np, rng, wrappers):
    """Phase 6: Qwen3-30B-A3B at full width through every entry point.
    Returns (launch counts summed over the runs, numbers)."""
    from qwen_inference_engine_tpu_torch.config import PRESETS

    cfg = PRESETS["qwen3-30b-a3b"]
    launches = {n: 0 for n in wrappers}
    out = {}

    def add(counts):
        for n, c in counts.items():
            launches[n] += c

    def prompts(n, length):
        lengths = length if isinstance(length, list) else [length] * n
        return [rng.integers(0, cfg.vocab_size, size=m).tolist()
                for m in lengths]

    # the JAX bench's MoE row: W4A8 gs 256, INT8 KV, batch 32 x 512, at the
    # preset's full depth of 48 layers, drawn once the dense phases' garbage
    # is collected (its peak memory is then the MoE runs')
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    params = moe_params(torch, cfg, 4, 256, cfg.num_layers)
    torch.cuda.synchronize()
    print(f"[moe] {cfg.name}: {cfg.num_layers} layers, {cfg.num_experts} "
          f"experts, top-{cfg.num_experts_per_tok}, W4A8 gs 256 drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated "
          f"({before:.2f} GiB before the draw)", flush=True)
    cfg8 = cfg.replace(act_bits=8)
    counts, out["w4a8 int8 kv"] = run_moe_generate(
        torch, cfg8, params, wrappers, prompts, torch.int8,
        "grouped_matmul4_a8", 32, "W4A8 gs 256, INT8 KV (the bench's MoE row)",
        profile=True)
    add(counts)
    for kv, spec in ((torch.bfloat16, False), (torch.int8, False),
                     (torch.bfloat16, True)):
        counts, out[f"serve {kv} spec={spec}"] = run_moe_serving(
            torch, cfg8, params, wrappers, rng, kv, spec)
        add(counts)
    moe_model_check(torch, cfg8, params, prompts, "W4A8 gs 256")
    del params
    torch.cuda.empty_cache()
    # the weight-only expert formats, depth cut for time
    for bits, gs, L, kern in ((4, 128, 24, "grouped_matmul4"),
                              (8, 128, 12, "grouped_matmul8")):
        params = moe_params(torch, cfg, bits, gs, L)
        counts, out[f"w{bits}a16"] = run_moe_generate(
            torch, cfg.replace(num_layers=L), params, wrappers, prompts,
            torch.bfloat16, kern, 16,
            f"W{bits}A16 gs {gs}, bf16 KV, depth cut to {L} of 48 layers for "
            f"time")
        add(counts)
        if bits == 4:
            moe_model_check(torch, cfg, params, prompts, "W4A16 gs 128")
        del params
        torch.cuda.empty_cache()
    out["loader"] = run_moe_loader_phase(torch, cfg)
    return launches, out


def run_moe_loader_phase(torch, cfg):
    """A 2-layer Qwen3-30B-A3B-width checkpoint in HF layout (router plus
    128 x 3 expert tensors a layer, two BF16 shards) from seeded bf16
    params, written into a temporary directory deleted afterwards:
    ``load_checkpoint`` bit for bit, ``quantize --bits 4`` then
    ``load_quantized`` equal to ``quantize_params`` of the loaded params,
    ``generate --qckpt`` equal to ``generate --ckpt --bits 4``."""
    import tempfile

    from qwen_inference_engine_tpu_torch.loader.qcheckpoint import (
        load_quantized,
    )
    from qwen_inference_engine_tpu_torch.loader.safetensors_loader import (
        load_checkpoint,
    )
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    cfg2 = cfg.replace(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(31)
    src = qwen.init_params(cfg2, gen, dtype=torch.bfloat16, device="cuda")
    sd = hf_state_dict(cfg2, src)
    n_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    out = {}
    with tempfile.TemporaryDirectory(prefix="qie_smoke_moe_") as tmp:
        d, q = os.path.join(tmp, "hf"), os.path.join(tmp, "q")
        t0 = time.perf_counter()
        write_hf_checkpoint(d, cfg2.to_hf_config(), sd, shards=2)
        out["write_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcfg, loaded = load_checkpoint(d)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        got = hf_state_dict(lcfg, loaded)
        bad = sorted(n for n, t in sd.items()
                     if not (got[n].is_cuda and torch.equal(got[n], t)))
        print(f"[moe loader] {cfg2.name} widths, 2 layers: {len(sd)} tensors, "
              f"{n_bytes / 1e9:.3f} GB, written in {out['write_s']:.2f} s; "
              f"load_checkpoint on the card {out['load_s']:.2f} s "
              f"({n_bytes / out['load_s'] / 1e9:.2f} GB/s), {len(bad)} "
              f"tensors differ", flush=True)
        if bad or set(got) != set(sd) or not lcfg.is_moe:
            fail(f"moe loader: tensors differ {bad[:4]}")
        del src, got
        t0 = time.perf_counter()
        _cli_ids(torch, ["quantize", "--ckpt", d, "--bits", "4",
                         "--group-size", "128", "--out", q])
        out["quantize_s"] = time.perf_counter() - t0
        qcfg, qp = load_quantized(q)
        want = quantize_params(loaded, QuantConfig(bits=4, group_size=128))
        names = ("q", "k", "v", "o", "moe_gate", "moe_up", "moe_down")
        diff = sorted(n for n in names
                      if not (torch.equal(qp["layers"][n].q, want["layers"][n].q)
                              and torch.equal(qp["layers"][n].scales,
                                              want["layers"][n].scales)))
        if not torch.equal(qp["layers"]["router"].w,
                           loaded["layers"]["router"].w):
            diff.append("router")
        print(f"[moe loader] quantize --bits 4 in {out['quantize_s']:.2f} s; "
              f"load_quantized differs from quantize_params of the loaded "
              f"params in {diff}", flush=True)
        if diff or not qcfg.is_moe:
            fail(f"moe loader: quantized checkpoint differs in {diff}")
        del loaded, want, qp
        torch.cuda.empty_cache()
        gen_args = ["--prompt", "Hello, H100.", "--prompt", "Experts",
                    "--max-new-tokens", "8", "--greedy", "--max-seq", "256"]
        ids = {"--qckpt": _cli_ids(torch, ["generate", "--qckpt", q,
                                           *gen_args]),
               "--ckpt --bits 4": _cli_ids(torch, ["generate", "--ckpt", d,
                                                   "--bits", "4",
                                                   *gen_args])}
        print(f"[moe loader] generate: {ids}", flush=True)
        if ids["--qckpt"] != ids["--ckpt --bits 4"] or any(
                len(v) != 2 or not all(len(r) >= 1 for r in v)
                for v in ids.values()):
            fail("moe loader: generate --qckpt and --ckpt --bits 4 differ")
    out["bytes"] = n_bytes
    out["load_gb_s"] = n_bytes / out["load_s"] / 1e9
    return out


# ----------------------------------------------------------------------
# offline-fused projections ([fused generate], [fused serve]), perplexity
# ([ppl]) and the CLI's hooks ([cli utils])
# ----------------------------------------------------------------------

FUSED_LENS = [37, 120, 300, 500]
FUSED_SERVE_LENS = [37, 120, 300, 511, 700, 900, 1100, 1408]
PPL_TOKENS, PPL_SEQ, PPL_BATCH = 2048, 512, 4


def _matmuls(counts):
    """The dense matmuls' and fused_mlp's launch counts of a run."""
    return {n: counts[n] for n in (*MATMULS, "fused_mlp")}


def run_fused_generate(torch, cases, wrappers, prompts, graph_runs):
    """[fused generate]: each case is (label, cfg, split params, fused
    params, its matmul kernel, lm_head launches a forward, the split
    engine's [graph generate] case).  Greedy ``Engine.generate`` of 4
    prompts of 37..500 tokens, 32 new, on the split and on the fused
    parameters: the fused run must launch its matmul 4 times a layer a
    forward (+ the lm_head) and no other matmul or fused_mlp; where the
    greedy tokens part is reported.  The prefill logits of the same
    prompts (M = 4 x 512 rows: one K slice at every width) must be
    bit-equal, fused against split (phase 5 holds the fused path to the
    fp32 rule).  Then [graph generate] on the fused engine: captured steps
    bit-equal to eager ones, host and device ms a step, beside the split
    case's.  Returns (launches, numbers)."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    total = {n: 0 for n in wrappers}
    out = {}
    for label, cfg, split, fused, kern, head, split_graph in cases:
        t0 = time.perf_counter()
        L = cfg.num_layers
        ids = prompts(FUSED_LENS)
        res, counts = {}, {}
        for kind, p in (("split", split), ("fused", fused)):
            eng = Engine(cfg, p, max_batch=4, max_seq=1024,
                         sampling=SamplingParams(greedy=True), device="cuda")
            warm_up(eng, prompts)
            # and the batch's own bucket once (its first prefill at these
            # widths allocates the activations' blocks)
            eng.generate(ids, max_new_tokens=2)
            for w in wrappers.values():
                w.launches = 0
            res[kind] = eng.generate(ids, max_new_tokens=NEW_TOKENS)
            counts[kind] = {n: w.launches for n, w in wrappers.items()}
            for n, c in counts[kind].items():
                total[n] += c
            if kind == "fused":
                before = {n: w.launches for n, w in wrappers.items()}
                graph = graph_generate_case(torch, eng, ids, f"{label} fused",
                                            wrappers)
                for n, w in wrappers.items():
                    total[n] += w.launches - before[n]
            del eng
            torch.cuda.empty_cache()
        r = res["fused"]
        toks = [t for row in r.token_ids for t in row]
        if not all(0 <= t < cfg.vocab_size for t in toks) \
                or len(set(toks)) < 2:
            fail(f"[fused generate] {label}: ids out of range or all "
                 f"identical")
        got = _matmuls(counts["fused"])
        want = {n: r.steps * (4 * L + head) if n == kern else 0 for n in got}
        per_step = graph["launches_per_step"]
        if got != want or per_step.get(kern) != 4 * L + head \
                or "fused_mlp" in per_step:
            fail(f"[fused generate] {label}: matmul launches {got}, want "
                 f"{want} ({r.steps} forwards); a captured step {per_step}")
        parts = [_first_part(a, b) for a, b in
                 zip(res["split"].token_ids, r.token_ids)]
        toks_t = torch.zeros((4, 512), dtype=torch.long, device="cuda")
        for i, p in enumerate(ids):
            toks_t[i, :len(p)] = torch.tensor(p, device="cuda")
        lens = torch.tensor(FUSED_LENS, device="cuda")
        logits = {}
        for kind, p in (("split", split), ("fused", fused)):
            cache = KVCache.create(L, 4, 1024, cfg.num_kv_heads, cfg.head_dim,
                                   device="cuda")
            with torch.inference_mode():
                logits[kind] = qwen.prefill_chunked(p, cfg, toks_t, lens,
                                                    cache, chunk=512)[0]
        equal = bool(torch.equal(logits["split"], logits["fused"]))
        dmax = (logits["split"] - logits["fused"]).abs().max().item()
        sg, fg = graph_runs[split_graph], graph
        secs = time.perf_counter() - t0
        print(f"[fused generate] {label}, {cfg.name} {L} layers, batch 4 "
              f"{FUSED_LENS}, {NEW_TOKENS} new: {kern} {4 * L + head} a "
              f"forward ({got[kern]} over {r.steps} forwards; split "
              f"{_matmuls(counts['split'])[kern]}), fused_mlp "
              f"{got['fused_mlp']} (split {counts['split']['fused_mlp']}) | "
              f"decode fused {r.decode_tokens_per_s:.1f} tok/s, split "
              f"{res['split'].decode_tokens_per_s:.1f} | ttft fused "
              f"{r.ttft_s * 1e3:.1f} ms, split "
              f"{res['split'].ttft_s * 1e3:.1f} | greedy tokens part at "
              f"steps {parts} of {NEW_TOKENS} | prefill logits bit-equal "
              f"{equal} (max |d| {dmax:.3g}) | captured step fused "
              f"{fg['captured']['step_ms']:.2f} ms host / "
              f"{fg['captured']['device_busy_ms']:.2f} device, split "
              f"{sg['captured']['step_ms']:.2f} / "
              f"{sg['captured']['device_busy_ms']:.2f}; eager fused "
              f"{fg['eager']['step_ms']:.2f} / "
              f"{fg['eager']['device_busy_ms']:.2f}, split "
              f"{sg['eager']['step_ms']:.2f} / "
              f"{sg['eager']['device_busy_ms']:.2f} | {secs:.1f} s",
              flush=True)
        if not equal:
            fail(f"[fused generate] {label}: prefill logits fused and split "
                 f"differ (max |d| {dmax}); one K slice at M = 2048 should "
                 f"give every column the same bits")
        out[label] = dict(
            launches_per_forward=4 * L + head, steps=r.steps,
            decode_tok_s=r.decode_tokens_per_s,
            split_decode_tok_s=res["split"].decode_tokens_per_s,
            ttft_ms=r.ttft_s * 1e3, split_ttft_ms=res["split"].ttft_s * 1e3,
            tokens_part_at=parts, prefill_logits_equal=equal,
            graph=fg, split_graph=split_graph, seconds=secs)
        del logits
        torch.cuda.empty_cache()
    return total, out


def run_fused_serve(torch, cfg, split, fused, wrappers, rng):
    """[fused serve]: ``ContinuousBatchingEngine`` at the JAX defaults (8
    slots, pages of 512, pieces of 256, prefix cache on, 8 ticks a sync),
    EOS off, 8 greedy requests of 37..1408 tokens, 32 new, on the split
    and then the fused W4A8 parameters.  Both runs must pass [serve]'s
    rule (every request finishes by length with ids in the vocabulary, not
    all identical); the fused run must launch the W4A8 matmul 4 times a
    layer for each decode tick and each prefill piece, and no other
    matmul.  Where each request's tokens part from the split run's is
    reported.  Returns (launches, numbers)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    t_start = time.perf_counter()
    L = cfg.num_layers
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in FUSED_SERVE_LENS]
    total = {n: 0 for n in wrappers}
    runs = {}
    for kind, p in (("split", split), ("fused", fused)):
        cb = ContinuousBatchingEngine(
            cfg, p, max_slots=8, page_size=PAGE, num_pages=40,
            max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
            sampling=SamplingParams(greedy=True), device="cuda")
        cb._eos = set()
        calls = {}
        for name in ("_decode_tick", "_run_piece"):
            count_calls(cb, name, calls)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, pr in enumerate(prompts):
            cb.submit(Request(request_id=i, prompt=pr,
                              max_new_tokens=NEW_TOKENS))
        done = cb.run_to_completion(sync_every=8)
        cb.check_page_invariants()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, c in counts.items():
            total[n] += c
        ids = [t for f in done for t in f.token_ids]
        if len(done) != len(prompts) or any(
                f.finish_reason != "length" or len(f.token_ids) != NEW_TOKENS
                for f in done) or not all(0 <= t < cfg.vocab_size
                                          for t in ids) or len(set(ids)) < 2:
            fail(f"[fused serve] {kind}: a request did not finish by length, "
                 f"or ids out of range or all identical")
        forwards = calls.get("_decode_tick", 0) + calls.get("_run_piece", 0)
        runs[kind] = dict(tokens={f.request_id: f.token_ids for f in done},
                          wall_s=wall, ticks=calls.get("_decode_tick", 0),
                          pieces=calls.get("_run_piece", 0),
                          matmuls=_matmuls(counts), **cb.metrics.snapshot())
        if kind == "fused":
            want = {n: 4 * L * forwards if n == "quant_matmul4_a8" else 0
                    for n in runs[kind]["matmuls"]}
            if runs[kind]["matmuls"] != want:
                fail(f"[fused serve] matmul launches {runs[kind]['matmuls']},"
                     f" want {want} ({forwards} forwards)")
        del cb
        torch.cuda.empty_cache()
    parts = {i: _first_part(runs["split"]["tokens"][i],
                            runs["fused"]["tokens"][i])
             for i in range(len(prompts))}
    f, sp = runs["fused"], runs["split"]
    secs = time.perf_counter() - t_start
    print(f"[fused serve] {cfg.name} {L} layers W4A8, 8 slots, page {PAGE}, "
          f"pieces of 256: {len(prompts)} requests {FUSED_SERVE_LENS}, "
          f"{NEW_TOKENS} new | fused: quant_matmul4_a8 "
          f"{f['matmuls']['quant_matmul4_a8']} = 4 x {L} x ({f['ticks']} "
          f"ticks + {f['pieces']} pieces); split "
          f"{sp['matmuls']['quant_matmul4_a8']} ({sp['ticks']} + "
          f"{sp['pieces']}) | decode fused {f['decode_tokens_per_s']:.1f} "
          f"tok/s, split {sp['decode_tokens_per_s']:.1f} | TTFT p50 fused "
          f"{f['ttft_p50_s'] * 1e3:.1f} ms, split "
          f"{sp['ttft_p50_s'] * 1e3:.1f} | wall fused {f['wall_s']:.2f} s, "
          f"split {sp['wall_s']:.2f} | tokens part from the split run's at "
          f"{parts} (of {NEW_TOKENS}; equal requests "
          f"{sum(v == NEW_TOKENS for v in parts.values())}) | {secs:.1f} s",
          flush=True)
    for r in runs.values():
        del r["tokens"]
    return total, dict(runs, tokens_part_at=parts, seconds=secs)


def run_ppl(torch, np, arms, wrappers):
    """[ppl]: ``utils/ppl.nll_of_windows`` over tests/test_ppl.py's stream
    formula at 2048 tokens (4 windows of 512) for each arm (label, cfg,
    params, batch_size, its matmul kernel, launches of it a batch): ppl,
    its delta to the bf16 arm, host ms a batch of windows (after one
    warm-up batch: the first calls at these shapes set up cuBLAS and the
    allocator's blocks) and launches a batch (flash_attention once a
    layer a batch).  Gates: every ppl finite;
    W8A16 within 0.02 relative of bf16, the INT4 arms within 0.10 (the
    limits of tests/test_ppl.py); fused within 1e-3 of split; batch_size 1
    within 1e-3 of batch_size 4.  Returns (launches, numbers)."""
    import math

    from qwen_inference_engine_tpu_torch.utils.ppl import nll_of_windows

    t_start = time.perf_counter()
    rng = np.random.default_rng(0)
    vocab = arms[0][1].vocab_size
    stream = ((np.arange(PPL_TOKENS) * 7 + rng.integers(0, 5, PPL_TOKENS))
              % vocab).astype(np.int64)
    windows = stream.reshape(-1, PPL_SEQ)
    total = {n: 0 for n in wrappers}
    out = {}
    for label, cfg, params, bs, kern, per_batch in arms:
        batches = -(-windows.shape[0] // bs)
        nll_of_windows(params, cfg, windows[:bs], batch_size=bs)  # warm-up
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nll, ntok = nll_of_windows(params, cfg, windows, batch_size=bs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / batches
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, c in counts.items():
            total[n] += c
        ppl = math.exp(nll / ntok)
        per = {n: c / batches for n, c in counts.items() if c}
        out[label] = dict(ppl=ppl, batch_size=bs, ms_per_batch=ms,
                          launches_per_batch=per)
        want = {n: per_batch if n == kern else 0 for n in MATMULS}
        got = {n: per.get(n, 0) for n in MATMULS}
        if not math.isfinite(ppl) or got != want or \
                per.get("flash_attention") != cfg.num_layers:
            fail(f"[ppl] {label}: ppl {ppl}, launches a batch {per} (want "
                 f"{want} and flash_attention {cfg.num_layers})")
    base = out["bf16"]["ppl"]
    for label, r in out.items():
        r["rel_to_bf16"] = abs(r["ppl"] - base) / base
        print(f"[ppl] {label}: ppl {r['ppl']:.6g}, delta to bf16 "
              f"{r['rel_to_bf16']:.4g} relative | batch_size {r['batch_size']}"
              f", {r['ms_per_batch']:.1f} ms a batch of windows | launches a "
              f"batch {r['launches_per_batch']}", flush=True)
    split, fused = out["W4A8 gs 256"], out["W4A8 gs 256 fused"]
    bs1 = out["W4A8 gs 256, batch_size 1"]
    gaps = {"fused vs split": abs(fused["ppl"] - split["ppl"]) / split["ppl"],
            "batch_size 1 vs 4": abs(bs1["ppl"] - split["ppl"]) / split["ppl"]}
    secs = time.perf_counter() - t_start
    print(f"[ppl] {arms[0][1].name} {arms[0][1].num_layers} layers, "
          f"{PPL_TOKENS} tokens in windows of {PPL_SEQ}: {gaps} | "
          f"{secs:.1f} s", flush=True)
    limits = {"W8A16 gs 128": 0.02, "W4A16 gs 128": 0.10, "W4A8 gs 256": 0.10,
              "W4A8 gs 256 fused": 0.10}
    bad = {k: out[k]["rel_to_bf16"] for k, lim in limits.items()
           if not out[k]["rel_to_bf16"] < lim}
    bad.update({k: v for k, v in gaps.items() if not v < 1e-3})
    if bad:
        fail(f"[ppl] over the limits: {bad}")
    return total, dict(out, gaps=gaps, seconds=secs)


def run_cli_utils(torch, ckpt):
    """[cli utils]: ``generate --chat --stats --profile DIR`` on the 2-layer
    checkpoint (W4A8): the stats line on stderr parses and has
    ``ttft_p50_s`` and the templated prompt's tokens; DIR holds a Chrome
    trace whose kernels include ``qmm_mma_kernel`` and ``flash_kernel``.
    Then a debug hook in a step body of ``engine/step_graph.StepGraphs``:
    enabled, it prints in the eager first step and raises in the capture
    of the second (a host print cannot replay), naming eager_steps()."""
    import contextlib
    import io
    import tempfile

    from qwen_inference_engine_tpu_torch.engine.step_graph import StepGraphs
    from qwen_inference_engine_tpu_torch.server import cli
    from qwen_inference_engine_tpu_torch.tokenizer import load_tokenizer
    from qwen_inference_engine_tpu_torch.utils import debug

    t0 = time.perf_counter()
    prompt = "Hello, H100."
    tok = load_tokenizer(ckpt)
    n_prompt = len(tok.encode(tok.apply_chat_template(
        [{"role": "user", "content": prompt}])))
    with tempfile.TemporaryDirectory(prefix="qie_prof_") as prof:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["generate", "--ckpt", ckpt, "--bits", "4",
                           "--act-bits", "8", "--chat", "--stats",
                           "--profile", prof, "--prompt", prompt,
                           "--max-new-tokens", "8", "--greedy",
                           "--max-seq", "256"])
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"[cli utils] generate returned {rc}")
        stats = json.loads(err.getvalue().strip().splitlines()[-1])
        files = os.listdir(prof)
        with open(os.path.join(prof, files[0])) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    qmm = sorted(n for n in names if "qmm_mma_kernel" in n)
    flash = sorted(n for n in names if "flash_kernel" in n)
    graphs = StepGraphs("cuda")
    x = torch.randn(4, 8, device="cuda")

    def body():
        return debug.dump_activation("[cli utils] a step's activation", x * 2)

    buf = io.StringIO()
    raised = ""
    debug.enable(True)
    try:
        with contextlib.redirect_stdout(buf):
            graphs.run("hook", body)                 # the eager first step
            try:
                graphs.run("hook", body)             # captured: raises
            except RuntimeError as e:
                raised = str(e)
    finally:
        debug.enable(False)
    torch.cuda.synchronize()
    printed = buf.getvalue()
    secs = time.perf_counter() - t0
    print(f"[cli utils] generate --chat --stats --profile (2-layer "
          f"checkpoint, W4A8): stats {stats} | prompt tokens with the chat "
          f"template {n_prompt} | trace {files}: {len(names)} event names, "
          f"qmm kernels {len(qmm)} ({qmm[:1]}), flash {flash[:1]} | debug "
          f"hook eager print {printed.strip()[:120]!r} | under capture "
          f"raised {raised[:100]!r} | {secs:.1f} s", flush=True)
    if "ttft_p50_s" not in stats or stats["prefill_tokens"] != n_prompt \
            or len(files) != 1 or not qmm or not flash:
        fail(f"[cli utils] stats {stats}, trace files {files}, qmm "
             f"{len(qmm)}, flash {len(flash)}")
    if "[cli utils] a step's activation: head=" not in printed \
            or "eager_steps()" not in raised:
        fail(f"[cli utils] debug hook: printed {printed!r}, raised {raised!r}")
    return dict(stats=stats, trace_events=len(names), qmm_kernels=len(qmm),
                flash_kernels=len(flash), seconds=secs)


def spawn_worlds(worlds):
    """``parallel.mesh.spawn`` of each ``(fn, world size, args)`` at once,
    one thread each (their ranks share the card; their spawn and set-up
    overlap): {world size: (the ranks' results, wall s)}.  A world that
    fails raises after all have ended."""
    import threading

    from qwen_inference_engine_tpu_torch.parallel.mesh import spawn

    out, errors = {}, []

    def run(fn, world, args):
        t0 = time.perf_counter()
        try:
            out[world] = (spawn(fn, world, device_type="cuda", args=args),
                          time.perf_counter() - t0)
        except BaseException as e:   # reported below, with the others'
            errors.append(e)

    threads = [threading.Thread(target=run, args=w) for w in worlds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


# ----------------------------------------------------------------------
# 7. tensor and data parallelism: gloo ranks sharing the card, and the
#    TP step over an NCCL group of one, captured
# ----------------------------------------------------------------------

TP_LENS = [37, 120, 300, 500]    # ragged: the append + contiguous decode
TP_NEW = 16
TP_SERVE_LENS = [37, 300, 700, 1100]
TP_SERVE_SHARED = 1024           # the second wave's prefix (two pages)
TP_SERVE_NEW = 16


def check_tp_shards(torch, cfg):
    """Every kernel of the TP paths at the shard shapes Qwen2.5-7B gives a
    rank at tp = 2 and 4 (``local_config``: 14 / 7 query heads over 2 / 1
    KV heads; q N 1792 / 896, k and v N 256 / 128, gate and up N 9472 /
    4736, o K 1792 / 896, down K 9472 / 4736, the lm_head's vocabulary
    shard N 76032 / 38016), against its plain version with the tolerance
    its single-card check applies: the four dense matmuls with groups of
    64 (the aligned size of the tp = 4 shards, ``tp_aligned_group_size``)
    over the unpadded shard K at M = 4 (a decode step), 256 (a serving
    piece) and 2048 (the prefill chunk of batch 4), the lm_head shard at
    M = 4; flash attention at the prefill chunk (B 4 x T 512) and the
    serving piece (B 1 x T 256); the ragged decode and its window append
    over the contiguous cache; the paged decode, the paged chunk and the
    two paged appends over a pool of the rank's heads.  Not timed.
    Returns {kernel: its largest absolute error}, which the kernels line
    folds in."""
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.parallel.tp_step import local_config

    g = torch.Generator(device="cuda").manual_seed(24)
    errs = {}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def held(name, tp, what, err, tol, ok=True, abs_err=None):
        errs[name] = max(errs.get(name, 0.0),
                         err if abs_err is None else abs_err)
        print(f"  [tp shards] {name} tp={tp} {what}: err {err:.3g} (tol "
              f"{tol:.3g})", flush=True)
        if not (err <= tol and ok):
            fail(f"[tp shards] {name} tp={tp} {what}: err {err} > {tol} or "
                 f"not finite / not bit-exact")

    gs, D, F = 64, cfg.hidden_size, cfg.intermediate_size
    for tp in (2, 4):
        c = local_config(cfg, tp)
        Hq, Hk, Dh = c.num_heads, c.num_kv_heads, c.head_dim
        projs = [("q", D, c.q_dim), ("k", D, c.kv_dim), ("v", D, c.kv_dim),
                 ("o", c.q_dim, D), ("gate", D, F // tp), ("up", D, F // tp),
                 ("down", F // tp, D)]
        cases = [(M, n, K, N) for M in (4, 256, 2048) for n, K, N in projs
                 if not (M > 4 and n in ("v", "up"))]
        cases.append((4, "lm_head", D, cfg.vocab_size // tp))
        for name, (bits, act_bits, rel, _) in MATMULS.items():
            kern = getattr(qm, name)
            plain = getattr(qm, name + "_plain")
            qmax = 7 if bits == 4 else 127
            for M, pname, K, N in cases:
                rows = K // 2 if bits == 4 else K
                q = torch.randint(-128 if bits == 4 else -127, 128,
                                  (1, rows, N), generator=g, device="cuda",
                                  dtype=torch.int8)
                s = torch.full((1, K // gs, N), K ** -0.5 / qmax,
                               device="cuda")
                x = rnd(M, K)
                if act_bits:
                    xq, sx = qm.quantize_activations(x)
                    args = (xq, sx.reshape(-1).contiguous(), q, s, 0)
                else:
                    args = (x, q, s, 0)
                args += (gs,) if bits == 4 else ()
                got, ref = kern(*args).float(), plain(*args).float()
                held(name, tp, f"{pname} M={M} K={K} N={N} gs {gs}",
                     (got - ref).abs().max().item(),
                     rel * ref.abs().max().item())
        # attention and the appends at the rank's heads
        for B, T in ((4, 512), (1, 256)):
            q, k, v = rnd(B, T, Hq, Dh), rnd(B, T, Hk, Dh), rnd(B, T, Hk, Dh)
            got = fa.flash_attention(q, k, v).float()
            ref = fa.flash_attention_plain(q, k, v).float()
            held("flash_attention", tp, f"B={B} T={T} Hq={Hq} Hk={Hk}",
                 (got - ref).abs().max().item(), 2e-2)
        L, B, S, layer = 2, 4, 1024, 1
        kc, vc = rnd(L, B, Hk, S, Dh), rnd(L, B, Hk, S, Dh)
        lens = torch.tensor([69, 152, 332, 1000], device="cuda")
        qd = rnd(B, 1, Hq, Dh)
        got = da.decode_attention_contiguous(qd, kc, vc, layer, lens).float()
        ref = da.decode_attention_contiguous_plain(qd, kc, vc, layer,
                                                   lens).float()
        held("decode_attention_contiguous", tp,
             f"B={B} lens {lens.tolist()} S={S} Hq={Hq} Hk={Hk}",
             (got - ref).abs().max().item(), 2e-2)
        kn, vn = rnd(B, 1, Hk, Dh), rnd(B, 1, Hk, Dh)
        mine, theirs = (kc.clone(), vc.clone()), (kc.clone(), vc.clone())
        ka.kv_append_ragged_t(*mine, kn, vn, lens.to(torch.int32), layer)
        ka.kv_append_ragged_t_plain(*theirs, kn, vn, lens.to(torch.int32),
                                    layer)
        diff = sum(int((a != b).sum()) for a, b in zip(mine, theirs))
        held("kv_append_ragged_t", tp, f"B={B} T=1 at {lens.tolist()} "
             f"Hk={Hk} (elements differing)", float(diff), 0.0)
        del kc, vc, mine, theirs
        # the paged kernels over a pool of the rank's heads, NaN in every
        # row no table holds and past each row's length
        k, v, tables = _paged_pool(torch, c, g)
        _stale(torch, k, v, tables, PAGED_LENS)
        lens_p = torch.tensor(PAGED_LENS, device="cuda", dtype=torch.int32)
        qp = rnd(len(PAGED_LENS), 1, Hq, Dh)
        args = (qp, k, v, tables, lens_p, PAGE, layer)
        got = pa.paged_decode_attention_stacked(*args)
        ref = pa.paged_decode_attention_plain(*args)
        held("paged_decode_attention_stacked", tp,
             f"8 slots lens {PAGED_LENS} Hq={Hq} Hk={Hk} (relative)",
             rel_err(got, ref), PAGED_TOL, bool(got.isfinite().all()),
             (got.float() - ref.float()).abs().max().item())
        k1, v1, t1 = _paged_pool(torch, c, g, rows=1)
        start, T = 700, 256
        _stale(torch, k1, v1, t1, [start + T])
        qc = rnd(1, T, Hq, Dh)
        args = (qc, k1, v1, t1, layer, start, PAGE)
        got = ca.paged_chunk_attention(*args)
        ref = ca.paged_chunk_attention_plain(*args)
        held("paged_chunk_attention", tp,
             f"B=1 T={T} start {start} Hq={Hq} Hk={Hk} (relative)",
             rel_err(got, ref), PAGED_TOL, bool(got.isfinite().all()),
             (got.float() - ref.float()).abs().max().item())
        k, v = k.nan_to_num(), v.nan_to_num()
        pos = lens_p - 1
        for name, new, at, tab in (
                ("paged_append_ragged", (len(PAGED_LENS), 1), pos, tables),
                ("paged_append_prefill", (1, T), 384, tables[:1])):
            nk, nv = rnd(*new, Hk, Dh), rnd(*new, Hk, Dh)
            mine, theirs = (k.clone(), v.clone()), (k.clone(), v.clone())
            getattr(ka, name)(*mine, nk, nv, at, tab, layer, page_size=PAGE)
            getattr(ka, name + "_plain")(*theirs, nk, nv, at, tab, layer,
                                         PAGE)
            diff = sum(int((a != b).sum()) for a, b in zip(mine, theirs))
            written = int((mine[0] != k).any(dim=-1).sum())
            held(name, tp, f"{new[0]} x {new[1]} tokens Hk={Hk} (elements "
                 f"differing; {written} K rows written)", float(diff), 0.0,
                 written == new[0] * new[1] * Hk)
        del k, v, k1, v1
        torch.cuda.empty_cache()
    return errs


def tp_model(torch, layers, seed=7):
    """Qwen2.5-7B W4A8 at ``layers`` layers with INT4 groups of 64 (the
    aligned size of the tp = 4 shards: o's local K 896, down's 4736),
    drawn packed on the current card from a seeded generator: the same
    params in every process."""
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
    )

    cfg = PRESETS["qwen2.5-7b"].replace(num_layers=layers)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg.replace(act_bits=8), init_quantized_params(
        cfg, gen, bits=4, group_size=64, device=dev)


def tp_serve_requests(prompts):
    """The [tp serve] traffic: the first wave, then two requests that share
    the 1100-token prompt's first two pages."""
    first = prompts[:len(TP_SERVE_LENS)]
    second = [first[-1][:TP_SERVE_SHARED] + p
              for p in prompts[len(TP_SERVE_LENS):]]
    return first, second


def tp_serve_run(torch, cfg, params, mesh, prompts, margins=None):
    """The serving engine at 4 slots over a bf16 pool of 512-token pages,
    prefix cache on: the two waves, each drained.  Returns (tokens by
    request, snapshot).  With ``margins`` (one rank) the waves run step
    by step and eager, each token's top-two logit margin recorded there
    (``record_margins``)."""
    from qwen_inference_engine_tpu_torch.engine import step_graph
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, mesh=mesh, max_slots=4, page_size=PAGE, num_pages=24,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
        sampling=SamplingParams(greedy=True), device=params["embed"].device)
    cb._eos = set()     # random weights can argmax onto EOS
    if margins is not None:
        record_margins(cb, margins)
    done = []
    with step_graph.eager_steps() if margins is not None \
            else contextlib.nullcontext():
        for wave, reqs in enumerate(tp_serve_requests(prompts)):
            for i, p in enumerate(reqs):
                cb.submit(Request(request_id=10 * wave + i, prompt=p,
                                  max_new_tokens=TP_SERVE_NEW))
            if margins is None:
                done += cb.run_to_completion(sync_every=8)
            else:
                while cb.has_work():
                    done += cb.step()
    return ({f.request_id: (f.finish_reason, f.token_ids) for f in done},
            cb.metrics.snapshot())


def tp_rank(rank, world_size, layers, jobs, prompts, serve_prompts,
            dp_prompts, uneven):
    """One rank of a gloo world on the card: for each (label, (dp, tp))
    job, the port under that mesh from the same seeded 7B W4A8 params (the
    [dp serve] / [mesh spec] jobs on their first ``DP_LAYERS`` layers,
    ``dp_job``; [tp fused] on them fused), its launches counted from 0
    just before the run and read just after; then 7c's models, each built
    here from its seed once phase 7's params are freed (``uneven_job``;
    ``uneven``: their inputs).  Returns {label: numbers}."""
    import torch

    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.parallel.mesh import make_mesh
    from qwen_inference_engine_tpu_torch.utils.metrics import (
        counted_wrappers,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = tp_model(torch, layers)
    wrappers = counted_wrappers()
    greedy = SamplingParams(greedy=True)
    out = {}
    built = {}
    for label, shape in jobs:
        mesh = make_mesh(shape)
        if label.startswith("tp fused"):
            from qwen_inference_engine_tpu_torch.quant.quantize import (
                fuse_projections,
            )

            cfg_c, params_c = dp_cut(torch, cfg, params)
            out[label] = uneven_job(torch, label, cfg_c,
                                    fuse_projections(params_c), mesh,
                                    wrappers, uneven)
            del params_c
            continue
        if label.startswith(("tp uneven", "sp prefill")):
            if params is not None:
                # phase 7's params go before 7c's models come
                params = None
                gc.collect()
                torch.cuda.empty_cache()
            key = "3b bf16" if label.startswith("sp prefill") \
                else label[len("tp uneven "):]
            if key not in built:
                built.clear()
                gc.collect()
                torch.cuda.empty_cache()
                _, name, fmt, n_layers, _ = next(u for u in UNEVEN
                                                 if u[0] == key)
                built[key] = uneven_model(torch, name, fmt, n_layers)
            out[label] = uneven_job(torch, label, *built[key], mesh,
                                    wrappers, uneven)
            continue
        if label.startswith(("dp serve", "mesh spec")):
            out[label] = dp_job(torch, label, *dp_cut(torch, cfg, params),
                                mesh, wrappers, dp_prompts)
            torch.cuda.empty_cache()
            continue
        if label.startswith("tp serve"):
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            toks, snap = tp_serve_run(torch, cfg, params, mesh,
                                      serve_prompts)
            torch.cuda.synchronize()
            out[label] = dict(tokens=toks, snapshot=snap,
                              wall_s=time.perf_counter() - t0,
                              launches={n: w.launches
                                        for n, w in wrappers.items()})
            continue
        eng = Engine(cfg, params, mesh=mesh, max_batch=4, max_seq=1024,
                     sampling=greedy)
        with torch.inference_mode():
            eng.start(prompts, TP_NEW, greedy)
            logits = eng.decode().float().cpu()
        for w in wrappers.values():
            w.launches = 0
        res = eng.generate(prompts, max_new_tokens=TP_NEW)
        out[label] = dict(
            logits=logits, tokens=res.token_ids, ttft_ms=res.ttft_s * 1e3,
            decode_tok_s=res.decode_tokens_per_s, steps=res.steps,
            capture=eng.graphs.capture, graphs=eng.graphs.captured,
            launches={n: w.launches for n, w in wrappers.items()})
        del eng
        torch.cuda.empty_cache()
    return out


def tp_graph_case(torch, cfg, params, prompts):
    """[tp graph]: ``make_tp_decode_fn`` over an NCCL group of one (a real
    all-reduce after o and down, inside the graph), captured, against its
    eager step from the same state: logits and cache bit-equal; each
    step's launches; host ms a step captured and eager."""
    import tempfile

    import torch.distributed as dist

    from qwen_inference_engine_tpu_torch.engine import step_graph
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )
    from qwen_inference_engine_tpu_torch.parallel.tp_step import (
        make_tp_decode_fn,
        make_tp_prefill_fn,
    )

    tmp = tempfile.mkdtemp(prefix="qie_rdv_")
    init_distributed("nccl", "file://" + os.path.join(tmp, "rdv"), 0, 1,
                     torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1))
        L = cfg.num_layers
        cache = KVCache.create(L, 4, 1024, cfg.num_kv_heads, cfg.head_dim,
                               device="cuda")
        toks = torch.zeros((4, 512), dtype=torch.long, device="cuda")
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = torch.tensor(p, device="cuda")
        lens = torch.tensor([len(p) for p in prompts], device="cuda")
        step = make_tp_decode_fn(cfg, mesh)
        graphs = step_graph.StepGraphs("cuda", capture=mesh.capturable)
        with torch.inference_mode():
            logits, _ = make_tp_prefill_fn(cfg, mesh)(params, toks, lens,
                                                      cache)
            tok, pos = logits.argmax(-1), lens.clone()
            state = [cache.k, cache.v, tok, pos]
            snap = [t.clone() for t in state]

            def body():
                out, _ = step(params, tok, pos, cache)
                return out

            def reset():
                for dst, src in zip(state, snap):
                    dst.copy_(src)

            with step_graph.eager_steps():
                want = body().clone()
            want_k = cache.k.clone()
            reset()
            graphs.run("tp", body)             # the key's first step: eager
            reset()
            got = graphs.run("tp", body).clone()   # captured, then replayed
            delta = dict(graphs._steps["tp"].delta)
            equal = bool(torch.equal(got, want)) and \
                bool(torch.equal(cache.k, want_k))

            def host_ms(eager, n=8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    if eager:
                        with step_graph.eager_steps():
                            graphs.run("tp", body)
                    else:
                        graphs.run("tp", body)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / n

            ms_graph, ms_eager = host_ms(False), host_ms(True)
    finally:
        dist.destroy_process_group()
    print(f"[tp graph] 7B W4A8 gs 64, {L} layers, batch 4 ragged, NCCL group "
          f"of one ({mesh.model_group.backend}): captured step bit-equal to "
          f"the eager one {equal} | a step's launches {delta} | host ms a "
          f"step captured {ms_graph:.2f}, eager {ms_eager:.2f}", flush=True)
    if not equal:
        fail("[tp graph]: the captured TP step differs from its eager step")
    if delta.get("all_reduce") != 2 * L or \
            delta.get("quant_matmul4_a8") != 7 * L:
        fail(f"[tp graph]: a step's launches {delta}, want all_reduce "
             f"{2 * L} and quant_matmul4_a8 {7 * L}")
    return delta, dict(bit_equal=equal, launches_per_step=delta,
                       host_ms_graph=ms_graph, host_ms_eager=ms_eager)


def run_tp_phases(torch, np, wrappers, layers=28):
    """[tp generate] (tp 2 and 4), [dp generate] (dp 2), [tp serve] (tp 2,
    bf16 pool) as gloo ranks sharing the card, each against the
    single-rank port run of the same seeded params, and [tp graph]; then,
    in the same worlds, [dp serve] at (2, 1) and (2, 2) and [mesh spec] at
    (2, 1) and (1, 2) on the params' first ``DP_LAYERS`` layers.  The
    ranks time-share the card's SMs: no number here is a TP or DP speed.
    Returns (every rank's kernel launches summed, the numbers)."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    rng = np.random.default_rng(24)
    cfg, params = tp_model(torch, layers)
    L = cfg.num_layers
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in TP_LENS]
    serve_prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                     for n in TP_SERVE_LENS + [40, 100]]
    greedy = SamplingParams(greedy=True)

    def first_step(c):
        eng = Engine(c, params, max_batch=4, max_seq=1024, sampling=greedy)
        with torch.inference_mode():
            eng.start(prompts, TP_NEW, greedy)
            logits = eng.decode().float().cpu()
        toks = eng.generate(prompts, max_new_tokens=TP_NEW).token_ids
        del eng
        return logits, toks

    ref, ref_toks = first_step(cfg)
    ref16, _ = first_step(cfg.replace(act_bits=0))
    # the bound: twice the activation quantization's own effect
    a8_vs_a16 = (ref - ref16).abs().max().item()
    bound = 2 * a8_vs_a16
    ref_serve, _ = tp_serve_run(torch, cfg, params, None, serve_prompts)
    delta, graph_run = tp_graph_case(torch, cfg, params, prompts)
    dp_ref = dp_references(torch, np, cfg, params)
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        fuse_projections,
    )

    cfg_c, params_c = dp_cut(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t7c = time.perf_counter()
    uneven_ref = uneven_references(torch, np, (cfg_c, fuse_projections(
        params_c)))
    del params_c
    print(f"[tp uneven] single-rank references: "
          f"{time.perf_counter() - t7c:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    numbers = {"tp graph": graph_run, "bound": bound,
               "a8_vs_a16": a8_vs_a16,
               "dp": dict(layers=DP_LAYERS, bound=dp_ref["bound"],
                          a8_vs_a16=dp_ref["a8_vs_a16"])}
    launches = {n: 0 for n in wrappers}
    plan = ((2, [("tp generate tp=2", (1, 2)), ("dp generate dp=2", (2, 1)),
                 ("tp serve tp=2", (1, 2))] + DP_JOBS[2] + FUSED_JOBS[2]),
            (4, [("tp generate tp=4", (1, 4))] + DP_JOBS[4] + FUSED_JOBS[4]
             + UNEVEN_JOBS))
    # both worlds at once: their ranks time-share the card
    done = spawn_worlds([(tp_rank, world, (layers, jobs, prompts,
                                           serve_prompts, dp_ref["prompts"],
                                           uneven_inputs(np)))
                         for world, jobs in plan])
    for world, jobs in plan:
        ranks, wall = done[world]
        print(f"[tp] a gloo world of {world} ranks on the card: {wall:.1f} s "
              f"(spawn, params, runs; beside the other world)", flush=True)
        for label, shape in jobs:
            per = [r[label] for r in ranks]
            dp_run = (label, shape) in DP_JOBS[world]
            new = label.startswith(("tp fused", "tp uneven", "sp prefill"))
            for r, p in enumerate(per):
                w = label.split(" ")
                head = (f"[{label}]" if dp_run or new
                        else f"[{w[0]} {w[1]}] {w[-1]}")
                print(f"{head} rank {r} launches "
                      f"{ {n: c for n, c in p['launches'].items() if c} }",
                      flush=True)
                for n in wrappers:
                    launches[n] += p["launches"][n]
            if new:
                numbers[label] = uneven_check(
                    torch, label, shape, per, uneven_ref[
                        " ".join(label.split(" ")[:2])
                        if label.startswith(("tp fused", "sp prefill"))
                        else label])
            elif dp_run and label.startswith("dp serve"):
                numbers[label] = dp_serve_check(torch, label, shape, per,
                                                dp_ref)
            elif dp_run:
                numbers[label] = mesh_spec_check(torch, label, shape, per,
                                                 dp_ref)
            else:
                numbers[label] = tp_check(torch, label, shape, per, ref,
                                          ref_toks, ref_serve, bound, L)
    return launches, numbers


def tp_check(torch, label, shape, per, ref, ref_toks, ref_serve, bound, L):
    """One TP / DP run's rule: every rank's tokens equal; generate's first
    decode-step logits (the ranks' vocabulary shards joined, or the data
    ranks' rows) within ``bound`` of the single-rank run; the kernels of
    the path launched on every rank, the collectives as many times as the
    path needs."""
    dp, tp = shape
    if label.startswith("tp serve"):
        toks = [p["tokens"] for p in per]
        if any(t != toks[0] for t in toks):
            fail(f"[{label}]: the ranks' tokens differ")
        bad = [k for k, (why, ids) in toks[0].items()
               if why != "length" or len(ids) != TP_SERVE_NEW]
        if len(toks[0]) != 6 or bad:
            fail(f"[{label}]: {len(toks[0])} of 6 requests, not by length: "
                 f"{bad}")
        same = sum(a == b for k in toks[0]
                   for a, b in zip(toks[0][k][1], ref_serve[k][1]))
        if same != 6 * TP_SERVE_NEW:
            fail(f"[{label}]: greedy tokens equal to the single-rank "
                 f"scheduler's {same} of {6 * TP_SERVE_NEW}")
        snap = per[0]["snapshot"]
        must = {"quant_matmul4_a8", "flash_attention", "paged_append_prefill",
                "paged_chunk_attention", "paged_append_ragged",
                "paged_decode_attention_stacked", "all_reduce", "all_gather"}
        for r, p in enumerate(per):
            missing = sorted(n for n in must if p["launches"][n] <= 0)
            if missing:
                fail(f"[{label}] rank {r}: not launched {missing}")
        if snap["prefix_hit_tokens"] < 2 * TP_SERVE_SHARED:
            fail(f"[{label}]: prefix hits {snap['prefix_hit_tokens']}")
        print(f"[tp serve] tp={tp}, 7B W4A8 gs 64, bf16 pool, 4 slots, pages "
              f"of {PAGE}: 6 requests (prompts {TP_SERVE_LENS}, then 2 "
              f"sharing {TP_SERVE_SHARED} tokens) by length on every rank, "
              f"tokens equal across ranks | greedy tokens equal to the "
              f"single-rank scheduler {same}/{6 * TP_SERVE_NEW} | prefix "
              f"hits {snap['prefix_hit_tokens']} tokens | wall "
              f"{per[0]['wall_s']:.2f} s (ranks share the card)", flush=True)
        return dict(tokens_equal_single=same, snapshot=snap,
                    wall_s=per[0]["wall_s"])
    toks = [p["tokens"] for p in per]
    if any(t != toks[0] for t in toks):
        fail(f"[{label}]: the ranks' tokens differ")
    if dp == 1:
        got = torch.cat([p["logits"] for p in per], dim=-1)
    else:
        got = torch.cat([p["logits"] for p in per], dim=0)
    if got.shape != ref.shape or not bool(got.isfinite().all()):
        fail(f"[{label}]: logits {tuple(got.shape)} not finite or not "
             f"{tuple(ref.shape)}")
    err = (got - ref).abs().max().item()
    same = sum(a == b for x, y in zip(toks[0], ref_toks) for a, b in zip(x, y))
    forwards = per[0]["steps"]
    must = {"quant_matmul4_a8": 7 * L * forwards, "flash_attention": L,
            "decode_attention_contiguous": L * (forwards - 1),
            "kv_append_ragged_t": L * (forwards - 1)}
    if tp > 1:
        # o and down a layer and the vocab-sharded embedding's sum a
        # forward; two gathers a greedy sample
        must.update(all_reduce=(2 * L + 1) * forwards,
                    all_gather=2 * forwards)
    for r, p in enumerate(per):
        wrong = {n: p["launches"][n] for n, c in must.items()
                 if p["launches"][n] != c}
        # gloo TP ranks take eager steps; a pure-DP rank captures its
        # single-card step
        if wrong or (tp > 1) == (p["capture"] or p["graphs"] > 0):
            fail(f"[{label}] rank {r}: launches {wrong} (want {must}), "
                 f"graphs {p['graphs']}, capture {p['capture']}")
    what = "vocabulary shards joined" if dp == 1 else "data ranks' rows"
    print(f"[{label.split(' ')[0]} {label.split(' ')[1]}] "
          f"{label.split(' ')[-1]}: 7B W4A8 gs 64, {L} layers, batch 4 "
          f"{TP_LENS}, {TP_NEW} tokens, gloo ranks sharing the card (eager "
          f"steps) | first decode step's logits ({what}) vs the single-rank "
          f"run max |d| {err:.4g} (bound: 2 x the single-rank W4A8 vs W4A16 "
          f"distance = {bound:.4g}) | tokens equal on every rank, equal to "
          f"the single-rank run {same}/{4 * TP_NEW} | ttft "
          f"{per[0]['ttft_ms']:.1f} ms, {per[0]['decode_tok_s']:.1f} tok/s "
          f"(not a TP speed: the ranks time-share the SMs)", flush=True)
    if not err <= bound:
        fail(f"[{label}]: logits {err} from the single-rank run, > {bound}")
    return dict(max_abs_diff=err, tokens_equal_single=same,
                ttft_ms=per[0]["ttft_ms"],
                decode_tok_s=per[0]["decode_tok_s"],
                launches=per[0]["launches"])


# ----------------------------------------------------------------------
# 7b. serving over a data axis and speculation under a mesh, in phase 7's
#     gloo worlds, on the first layers of their 7B W4A8 params
# ----------------------------------------------------------------------

# the depth of [dp serve] and [mesh spec]: the logits gathers, the page
# copies and the (2, 2) world's all-reduces stage through the host, and
# the whole smoke must stay within its time
DP_LAYERS = 4
DP_CUT = (f"depth cut to {DP_LAYERS} of 28 layers for time (gloo's host "
          f"round trips: a gather a tick, two all-reduces a layer at tp 2)")
DP_SERVE_LENS = [37, 300, 700, 1100, 120, 500, 900, 1050]
DP_SERVE_SHARED = 1024   # the second wave's prefix: slot 7's two pages
DP_SERVE_NEW = 16
DP_SPEC_LENS = [180, 300, 450, 600]   # echo prompts, as [generate spec]
DP_SPEC_NEW = 32
DP_SPEC_SEQ = 1280                    # the 900-token prompt's bucket + 32
# the jobs phase 7's worlds of 2 and 4 ranks run after their own
DP_JOBS = {2: [("dp serve dp=2", (2, 1)), ("mesh spec dp=2", (2, 1)),
               ("mesh spec tp=2", (1, 2))],
           4: [("dp serve dp=2 tp=2", (2, 2))]}


def dp_cut(torch, cfg, params):
    """The first ``DP_LAYERS`` layers of the 7B W4A8 params (views: no
    copy), and their config."""
    from qwen_inference_engine_tpu_torch.models.qwen import map_params

    return cfg.replace(num_layers=DP_LAYERS), dict(
        params, layers=map_params(params["layers"],
                                  lambda t: t[:DP_LAYERS]))


def dp_serve_requests(prompts):
    """[dp serve]'s traffic: 8 prompts on slots 0-7 (data group 1 at dp 2
    owns 4-7), then two on slots 0 and 1 (group 0): slot 7's prompt's first
    1024 tokens (its two pages, written by group 1) and its first 1040 (a
    partial tail copied from its third page too), each with a tail of its
    own.  Request ids 0-7, then 10 and 11."""
    first, src = prompts[:8], prompts[7]
    second = [src[:DP_SERVE_SHARED] + prompts[8],
              src[:DP_SERVE_SHARED + 16] + prompts[9]]
    return first, second


def top2_margin(logits):
    """The gap between the two largest logits of each row ``[..., V]``."""
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu()


def record_margins(cb, margins):
    """Record in ``margins`` each token's top-two logit margin of the
    serving engine ``cb`` (one rank), by request id and token index: its
    last prefill piece's and its ticks' logits."""
    run_piece, last_piece, decode = (cb._run_piece, cb._pieces[True],
                                     cb._decode_fn)
    piece_of = {}

    def on_piece(run, *a, **k):
        piece_of["rid"] = run.request.request_id
        return run_piece(run, *a, **k)

    def on_last_piece(*a):
        logits = last_piece(*a)
        margins.setdefault(piece_of["rid"], {})[0] = float(
            top2_margin(logits[0]))
        return logits

    def on_tick(*a):
        logits, cache = decode(*a)
        m = top2_margin(logits)
        for run in cb._slots:
            if run is not None and run.prefill_done:
                margins.setdefault(run.request.request_id, {})[
                    len(run.generated)] = float(m[run.slot])
        return logits, cache

    cb._run_piece, cb._decode_fn = on_piece, on_tick
    cb._pieces[True] = on_last_piece


def dp_serve_run(torch, cfg, params, mesh, prompts, margins=None):
    """The serving engine on 8 slots over a bf16 pool of 512-token pages
    (pieces of 256, prefix cache on), greedy, EOS off: the two waves, each
    drained and the page invariants checked.  Returns (tokens by request,
    the snapshot with the pages copied between data groups).  With
    ``margins`` (a dict; one rank only) the waves run step by step and
    eager, each token's top-two logit margin recorded there by request id
    and token index (a chained window samples as its ticks one by one, and
    a replay as its eager step, so the tokens are the same)."""
    from qwen_inference_engine_tpu_torch.engine import step_graph
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, mesh=mesh, max_slots=8, page_size=PAGE, num_pages=40,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
        sampling=SamplingParams(greedy=True), device=params["embed"].device)
    cb._eos = set()     # random weights can argmax onto EOS
    if margins is not None:
        record_margins(cb, margins)
    done = []
    with step_graph.eager_steps() if margins is not None \
            else contextlib.nullcontext():
        for wave, reqs in enumerate(dp_serve_requests(prompts)):
            for i, p in enumerate(reqs):
                cb.submit(Request(request_id=10 * wave + i, prompt=p,
                                  max_new_tokens=DP_SERVE_NEW))
            if margins is None:
                done += cb.run_to_completion(sync_every=8)
            else:
                while cb.has_work():
                    done += cb.step()
            cb.check_page_invariants()
    return ({f.request_id: (f.finish_reason, f.token_ids) for f in done},
            dict(cb.metrics.snapshot(), pages_shared=cb.pages_shared))


def spec_margins(torch, eng, prompts):
    """``eng.generate_speculative`` of ``prompts`` (greedy, k = SPEC_K) on
    one rank, with the top-two logit margin each emitted token was picked
    from (the prefill's for token 0; after, the verify column whose inputs
    were the emitted tokens): (ids, {row: {token index: margin}})."""
    from qwen_inference_engine_tpu_torch.engine import speculative as spec

    forward, logits_of, prefill = (spec.forward_hidden, spec.compute_logits,
                                   spec.prefill)
    verifies, first = [], []

    def on_forward(params_, cfg_, tokens, positions, *a, **k):
        verifies.append([tokens.tolist(), positions.tolist()])
        return forward(params_, cfg_, tokens, positions, *a, **k)

    def on_logits(*a, **k):
        out = logits_of(*a, **k)
        verifies[-1].append(top2_margin(out))
        return out

    def on_prefill(*a, **k):
        out = prefill(*a, **k)
        first.append(top2_margin(out[0]))
        return out

    with Swapped([(spec, "forward_hidden", on_forward),
                  (spec, "compute_logits", on_logits),
                  (spec, "prefill", on_prefill)]):
        ids = eng.generate_speculative(prompts, max_new_tokens=DP_SPEC_NEW,
                                       k=SPEC_K)
    margins = {b: {0: float(first[0][b])} for b in range(len(prompts))}
    for tokens, positions, m in verifies:
        for b, p in enumerate(prompts):
            for j in range(SPEC_K + 1):
                i = positions[b][j] + 1 - len(p)
                if 0 < i < len(ids[b]) and i not in margins[b] \
                        and tokens[b][1:j + 1] == ids[b][i - j:i]:
                    margins[b][i] = float(m[b, j])
    return ids, margins


def generate_margins(torch, eng, prompts, max_new=DP_SPEC_NEW):
    """Greedy ``eng.generate`` of ``prompts`` on one rank, eager steps (a
    replay is its eager step), with each token's top-two logit margin:
    (ids, {row: {token index: margin}})."""
    from qwen_inference_engine_tpu_torch.engine import step_graph
    from qwen_inference_engine_tpu_torch.models import qwen

    compute, steps = qwen.compute_logits, []

    def on_logits(*a, **k):
        out = compute(*a, **k)
        steps.append(top2_margin(out))
        return out

    with Swapped([(qwen, "compute_logits", on_logits)]), \
            step_graph.eager_steps():
        ids = eng.generate(prompts, max_new_tokens=max_new).token_ids
    return ids, {b: {i: float(steps[i][b]) for i in range(len(ids[b]))}
                 for b in range(len(prompts))}


def margin_parts(tag, side, got, want, margins, bound):
    """Where each request's greedy tokens ``got[rid]`` part from the
    single-rank run's ``want[rid]``: the first such position ``i``, and
    whether it is a near-tie (the single-rank run's own top-two logit
    margin there, ``margins[rid][i]``, below ``bound``).  Returns (tokens
    equal before the parts, the parts)."""
    same, parts = 0, []
    for rid, w in want.items():
        have = got[rid]
        i = next((j for j, (x, y) in enumerate(zip(have, w)) if x != y),
                 None)
        if i is None:
            same += len(w)
            continue
        same += i
        m = margins[rid][i]
        parts.append({"request": rid, "position": i, "single": w[i],
                      side: have[i], "single_margin": m,
                      "near_tie": m < bound})
        print(f"[{tag}] request {rid} parts from the single-rank run at "
              f"token {i}: single {w[i]}, {side} {have[i]}, the single-rank "
              f"top-two margin there {m:.4g} (bound {bound:.4g})",
              flush=True)
    return same, parts


def dp_job(torch, label, cfg, params, mesh, wrappers, prompts):
    """One [dp serve] / [mesh spec] job on this rank (``prompts``: the
    serving and the speculative traffic): the serving engine's two waves,
    or ``Engine.generate_speculative``, its launches and collective bytes
    counted from 0 just before the run and read just after."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine

    serve_prompts, spec_prompts = prompts
    sending = {n: w for n, w in wrappers.items() if hasattr(w, "sent_bytes")}
    for w in wrappers.values():
        w.launches = 0
    sent = {n: w.sent_bytes for n, w in sending.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if label.startswith("dp serve"):
        toks, snap = dp_serve_run(torch, cfg, params, mesh, serve_prompts)
        rec = dict(tokens=toks, snapshot=snap)
    else:
        eng = Engine(cfg.replace(eos_token_ids=()), params, mesh=mesh,
                     max_batch=4, max_seq=DP_SPEC_SEQ)
        rec = dict(tokens=eng.generate_speculative(
            spec_prompts, max_new_tokens=DP_SPEC_NEW, k=SPEC_K))
        del eng
    torch.cuda.synchronize()
    rec.update(wall_s=time.perf_counter() - t0,
               launches={n: w.launches for n, w in wrappers.items()},
               sent_bytes={n: w.sent_bytes - sent[n]
                           for n, w in sending.items()})
    return rec


def dp_references(torch, np, cfg, params):
    """The single-rank runs [dp serve] and [mesh spec] are held to, on
    ``dp_cut`` of phase 7's params: the serving engine's two waves,
    ``generate_speculative`` and greedy ``Engine.generate`` (EOS off), each
    token with its top-two logit margin, and the near-tie bound: twice the
    single-rank W4A8 vs W4A16 distance of a first decode step's logits
    (phase 7's rule at this depth)."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    rng = np.random.default_rng(27)
    cfg, params = dp_cut(torch, cfg, params)
    serve_prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                     for n in DP_SERVE_LENS + [40, 60]]
    spec_prompts = echo_prompts(rng, cfg.vocab_size, DP_SPEC_LENS)
    serve, snap = dp_serve_run(torch, cfg, params, None, serve_prompts)
    serve_margins = {}
    stepped, _ = dp_serve_run(torch, cfg, params, None, serve_prompts,
                              serve_margins)
    if stepped != serve:
        fail("[dp serve]: one rank's step-by-step eager tokens differ from "
             "its chained captured ones")
    greedy = SamplingParams(greedy=True)
    logits = {}
    for bits in (8, 0):
        eng = Engine(cfg.replace(eos_token_ids=(), act_bits=bits), params,
                     max_batch=4, max_seq=DP_SPEC_SEQ, sampling=greedy)
        with torch.inference_mode():
            eng.start(spec_prompts, DP_SPEC_NEW, greedy)
            logits[bits] = eng.decode().float().cpu()
            if bits == 8:
                gen = generate_margins(torch, eng, spec_prompts)
                spec = spec_margins(torch, eng, spec_prompts)
        del eng
    a8_vs_a16 = (logits[8] - logits[0]).abs().max().item()
    torch.cuda.empty_cache()
    for what, toks, margins in (
            ("serve", {k: t for k, (_, t) in serve.items()}, serve_margins),
            ("spec", dict(enumerate(spec[0])), spec[1]),
            ("generate", dict(enumerate(gen[0])), gen[1])):
        lost = [(k, i) for k, t in toks.items() for i in range(len(t))
                if i not in margins.get(k, {})]
        if lost:
            fail(f"[dp references]: no {what} margin for (request, token) "
                 f"{lost[:8]}")
    return dict(serve=serve, serve_margins=serve_margins, snapshot=snap,
                prompts=(serve_prompts, spec_prompts), spec=spec,
                generate=gen, a8_vs_a16=a8_vs_a16, bound=2 * a8_vs_a16)


def dp_serve_check(torch, label, shape, per, ref):
    """One [dp serve] run's rule: every rank's tokens equal, every request
    by length; each request's greedy tokens equal to the single-rank
    scheduler's or parting at a near-tie; the prefix hits equal to the
    single rank's; a page copied between data groups on every rank; the
    paged kernels, the logits gather and the page broadcast launched on
    every rank (the all-reduces too at tp 2: the sums, and the per-token
    maxima of o's and down's whole-row activation scales).  Returns the
    numbers."""
    dp, tp = shape
    toks = [p["tokens"] for p in per]
    if any(t != toks[0] for t in toks):
        fail(f"[{label}]: the ranks' tokens differ")
    bad = [k for k, (why, ids) in toks[0].items()
           if why != "length" or len(ids) != DP_SERVE_NEW]
    if len(toks[0]) != 10 or bad:
        fail(f"[{label}]: {len(toks[0])} of 10 requests, not by length: "
             f"{bad}")
    same, ties = margin_parts(
        label, "dp", {k: t for k, (_, t) in toks[0].items()},
        {k: t for k, (_, t) in ref["serve"].items()}, ref["serve_margins"],
        ref["bound"])
    if not all(t["near_tie"] for t in ties):
        fail(f"[{label}]: a part from the single-rank run is not a near-tie "
             f"{ties}")
    hits = [p["snapshot"]["prefix_hit_tokens"] for p in per]
    want_hits = ref["snapshot"]["prefix_hit_tokens"]
    if any(h != want_hits for h in hits) or want_hits < 2 * DP_SERVE_SHARED:
        fail(f"[{label}]: prefix hits {hits}, the single rank's {want_hits}")
    must = {"quant_matmul4_a8", "flash_attention", "paged_append_prefill",
            "paged_chunk_attention", "paged_append_ragged",
            "paged_decode_attention_stacked"}
    must |= {"gather_data", "broadcast_data"}
    must |= {"all_reduce"} if tp > 1 else set()
    for r, p in enumerate(per):
        missing = sorted(n for n in must if p["launches"][n] <= 0)
        if missing or p["snapshot"]["pages_shared"] <= 0:
            fail(f"[{label}] rank {r}: not launched {missing}, pages "
                 f"copied between groups {p['snapshot']['pages_shared']}")
    n_tok = 10 * DP_SERVE_NEW
    copies = [(p["launches"]["broadcast_data"],
               p["sent_bytes"]["broadcast_data"]) for p in per]
    print(f"[dp serve] dp={dp} tp={tp}, 7B W4A8 gs 64, {DP_LAYERS} layers "
          f"({DP_CUT}), bf16 pool, 8 slots, pages of {PAGE}: 10 requests "
          f"(prompts {DP_SERVE_LENS}, then 2 sharing {DP_SERVE_SHARED} and "
          f"{DP_SERVE_SHARED + 16} tokens of slot 7's) by length, tokens "
          f"equal on every rank | greedy tokens equal to the single-rank "
          f"scheduler {same}/{n_tok} ({len(ties)} parts, "
          f"{sum(t['near_tie'] for t in ties)} of them near-ties below "
          f"{ref['bound']:.4g}) | prefix hits {hits[0]} tokens = the "
          f"single rank's | pages copied between data groups "
          f"{per[0]['snapshot']['pages_shared']}; the page broadcasts "
          f"(launches, bytes sent) by rank {copies} | logits gathered "
          f"{per[0]['launches']['gather_data']} times, "
          f"{per[0]['sent_bytes']['gather_data']} bytes sent a rank | TTFT "
          f"p50 {per[0]['snapshot']['ttft_p50_s'] * 1e3:.1f} ms, wall "
          f"{per[0]['wall_s']:.2f} s (the ranks share the card: no DP speed)",
          flush=True)
    return dict(tokens_equal_single=same, tokens=n_tok, parts=ties,
                prefix_hit_tokens=hits[0],
                pages_shared=per[0]["snapshot"]["pages_shared"],
                page_broadcasts=copies, wall_s=per[0]["wall_s"],
                gather_bytes=per[0]["sent_bytes"]["gather_data"])


def mesh_spec_check(torch, label, shape, per, ref):
    """One [mesh spec] run's rule: every rank's ids equal; each row equal
    to the single-rank ``generate_speculative``'s and to the single-rank
    greedy ``generate``'s, or parting at a near-tie; flash, the
    contiguous chunk kernel and ``kv_append_ragged_t`` launched on every
    rank (the stop test's gather at dp 2, the all-reduces at tp 2).
    Returns the numbers."""
    dp, tp = shape
    ids = [p["tokens"] for p in per]
    if any(t != ids[0] for t in ids):
        fail(f"[{label}]: the ranks' ids differ")
    got = dict(enumerate(ids[0]))
    parts = {}
    for what in ("spec", "generate"):
        want, margins = ref[what]
        parts[what] = margin_parts(f"{label} vs {what}", "mesh", got,
                                   dict(enumerate(want)), margins,
                                   ref["bound"])
        if not all(t["near_tie"] for t in parts[what][1]):
            fail(f"[{label}]: a part from the single-rank {what} is not a "
                 f"near-tie: {parts[what][1]}")
    must = {"quant_matmul4_a8", "flash_attention",
            "chunk_attention_contiguous", "kv_append_ragged_t"}
    must |= {"gather_data"} if dp > 1 else {"all_reduce", "all_gather"}
    for r, p in enumerate(per):
        missing = sorted(n for n in must if p["launches"][n] <= 0)
        if missing:
            fail(f"[{label}] rank {r}: not launched {missing}")
    n_tok = len(DP_SPEC_LENS) * DP_SPEC_NEW
    print(f"[mesh spec] dp={dp} tp={tp}, 7B W4A8 gs 64, {DP_LAYERS} layers "
          f"({DP_CUT}): generate_speculative k {SPEC_K}, batch 4 of echo "
          f"prompts {DP_SPEC_LENS}, {DP_SPEC_NEW} new, EOS off: ids equal on "
          f"every rank | equal to the single-rank generate_speculative "
          f"{parts['spec'][0]}/{n_tok} ({len(parts['spec'][1])} near-ties), "
          f"to the single-rank greedy generate {parts['generate'][0]}/"
          f"{n_tok} ({len(parts['generate'][1])} near-ties) | wall "
          f"{per[0]['wall_s']:.2f} s (the ranks share the card)", flush=True)
    return dict(tokens=n_tok, wall_s=per[0]["wall_s"],
                **{f"tokens_equal_single_{w}": v[0] for w, v in parts.items()},
                **{f"near_ties_{w}": v[1] for w, v in parts.items()})


# ----------------------------------------------------------------------
# 7c. models that do not split evenly over the model axis (the JAX
#     package's GSPMD cases: parallel/tp_step.TpLayout), fused projections
#     under TP and the sequence-parallel prefill, in phase 7's gloo worlds
# ----------------------------------------------------------------------

# [tp uneven]'s models: (label, preset, format, layers, serve too)
UNEVEN_CUT = 8     # the bf16 runs' depth, cut for time
UNEVEN = [("7b w4a8 gs256", "qwen2.5-7b", "w4a8", 28, True),
          ("3b w4a8 gs256", "qwen2.5-3b", "w4a8", 36, True),
          ("0.5b bf16", "qwen2.5-0.5b", "bf16", 24, False),
          ("3b bf16", "qwen2.5-3b", "bf16", UNEVEN_CUT, False)]
SP_T = 1024        # [sp prefill]: 2 x SP_T tokens on the 3b bf16 model
UNEVEN_VOCAB = 151936   # the prompts' ids, below every model's vocabulary
# the jobs of phase 7's worlds after 7b: [tp fused] on phase 7's params
# (before they are freed), then the new models at tp 4
FUSED_JOBS = {2: [("tp fused tp=2", (1, 2))],
              4: [("tp fused dp=2 tp=2", (2, 2))]}
UNEVEN_JOBS = [(f"tp uneven {u[0]}", (1, 4)) for u in UNEVEN] + \
    [("sp prefill tp=4", (1, 4))]


def uneven_model(torch, name, fmt, layers, seed=28):
    """A preset at ``layers`` layers from a seeded generator on the current
    card (the same in every process): W4A8 with INT4 groups of 256 (the
    JAX bench's format, which no even split takes at tp 4) or bf16."""
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_params,
        init_quantized_params,
    )

    cfg = PRESETS[name].replace(num_layers=layers)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    if fmt == "w4a8":
        return cfg.replace(act_bits=8), init_quantized_params(
            cfg, gen, bits=4, group_size=256, device=dev)
    return cfg, init_params(cfg, gen, dtype=torch.bfloat16, device=dev)


def uneven_inputs(np):
    """[tp uneven]'s batch (TP_LENS), serving traffic (as [tp serve]'s) and
    [sp prefill]'s 2 x SP_T tokens."""
    rng = np.random.default_rng(28)
    prompts = [rng.integers(0, UNEVEN_VOCAB, size=n).tolist()
               for n in TP_LENS]
    serve = [rng.integers(0, UNEVEN_VOCAB, size=n).tolist()
             for n in TP_SERVE_LENS + [40, 100]]
    return prompts, serve, rng.integers(0, UNEVEN_VOCAB, size=(2, SP_T))


def first_step_and_margins(torch, cfg, params, prompts):
    """One rank: the first decode step's logits of greedy
    ``Engine.generate`` of ``prompts`` (TP_NEW tokens) and the run's ids
    with each token's top-two logit margin."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    greedy = SamplingParams(greedy=True)
    eng = Engine(cfg, params, max_batch=4, max_seq=1024, sampling=greedy,
                 device=params["embed"].device)
    with torch.inference_mode():
        eng.start(prompts, TP_NEW, greedy)
        logits = eng.decode().float().cpu()
    gen = generate_margins(torch, eng, prompts, TP_NEW)
    del eng
    return logits, gen


def bound_of(torch, cfg, params, prompts, logits):
    """Phase 7's bound for a model: twice its single-rank distance from
    the same weights one quantization step away (W4A8 vs W4A16
    activations; bf16 vs INT8 weights, groups of 128)."""
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    if cfg.act_bits == 8:
        other, _ = first_step_and_margins(torch, cfg.replace(act_bits=0),
                                          params, prompts)
    else:
        other, _ = first_step_and_margins(
            torch, cfg, quantize_params(params, QuantConfig(
                bits=8, group_size=128)), prompts)
    return 2 * (logits - other).abs().max().item()


def uneven_references(torch, np, fused_of):
    """The single-rank runs 7c is held to: ``fused_of`` (phase 7's params
    cut to DP_LAYERS and fused) and each of UNEVEN, the first decode
    step's logits, greedy ids with margins, the bound, the serving
    engine's ids with margins, and [sp prefill]'s logits."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models.qwen import prefill

    prompts, serve_prompts, sp_tokens = uneven_inputs(np)
    refs = {}
    cfg, params = fused_of
    logits, gen = first_step_and_margins(torch, cfg, params, prompts)
    refs["tp fused"] = dict(logits=logits, generate=gen,
                            bound=bound_of(torch, cfg, params, prompts,
                                           logits))
    for label, name, fmt, layers, serve in UNEVEN:
        t0 = time.perf_counter()
        cfg, params = uneven_model(torch, name, fmt, layers)
        logits, gen = first_step_and_margins(torch, cfg, params, prompts)
        ref = dict(logits=logits, generate=gen,
                   bound=bound_of(torch, cfg, params, prompts, logits))
        if serve:
            margins = {}
            ref["serve"] = tp_serve_run(torch, cfg, params, None,
                                        serve_prompts, margins)[0]
            ref["serve_margins"] = margins
        if label == "3b bf16":
            dev = params["embed"].device
            tokens = torch.as_tensor(sp_tokens, device=dev)
            cache = KVCache.create(cfg.num_layers, 2, SP_T,
                                   cfg.num_kv_heads, cfg.head_dim,
                                   dtype=params["embed"].dtype, device=dev)
            with torch.inference_mode():
                sp, _ = prefill(params, cfg, tokens,
                                torch.full((2,), SP_T, device=dev), cache)
            refs["sp prefill"] = dict(logits=sp.float().cpu(),
                                      bound=ref["bound"])
            del cache
        refs[f"tp uneven {label}"] = ref
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[tp uneven] single-rank reference of {label} ({layers} "
              f"layers): {time.perf_counter() - t0:.1f} s", flush=True)
    return refs


def uneven_job(torch, label, cfg, params, mesh, wrappers, inputs):
    """One 7c job on this rank: greedy ``Engine.generate`` of the batch
    (and, for the W4A8 models, the serving engine's two waves), or the
    sequence-parallel prefill; launches counted from 0 just before each
    run and read just after, the layout, the peak memory and the wall
    time."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.parallel.sharding import (
        batch_shard,
        shard_params,
    )
    from qwen_inference_engine_tpu_torch.parallel.tp_step import (
        make_tp_sp_prefill_fn,
        tp_layout,
    )

    prompts, serve_prompts, sp_tokens = inputs
    greedy = SamplingParams(greedy=True)
    dev = params["embed"].device
    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = {}
    if label.startswith("sp prefill"):
        layout = tp_layout(cfg, params, mesh.tp)
        params_l = shard_params(params, mesh, layout)
        cfg_l = layout.local_config(cfg)
        cache = KVCache.create(cfg.num_layers, 2, SP_T, cfg_l.num_kv_heads,
                               cfg.head_dim, dtype=params["embed"].dtype,
                               device=dev)
        tokens = batch_shard(torch.as_tensor(sp_tokens, device=dev),
                             mesh, (None, "model"))
        for w in wrappers.values():
            w.launches = 0
        with torch.inference_mode():
            logits, _ = make_tp_sp_prefill_fn(cfg, mesh, layout=layout)(
                params_l, tokens, torch.full((2,), SP_T, device=dev),
                cache)
        rec.update(logits=logits.float().cpu(), tokens_shape=tuple(
            tokens.shape), launches={n: w.launches
                                     for n, w in wrappers.items()})
        del params_l, cache
    else:
        eng = Engine(cfg, params, mesh=mesh, max_batch=4, max_seq=1024,
                     sampling=greedy, device=dev)
        layout = eng.layout
        with torch.inference_mode():
            eng.start(prompts, TP_NEW, greedy)
            logits = eng.decode().float().cpu()
        for w in wrappers.values():
            w.launches = 0
        res = eng.generate(prompts, max_new_tokens=TP_NEW)
        rec.update(logits=logits, tokens=res.token_ids, steps=res.steps,
                   ttft_ms=res.ttft_s * 1e3,
                   decode_tok_s=res.decode_tokens_per_s,
                   launches={n: w.launches for n, w in wrappers.items()})
        del eng
        if cfg.act_bits == 8 and label.startswith("tp uneven"):
            for w in wrappers.values():
                w.launches = 0
            toks, snap = tp_serve_run(torch, cfg, params, mesh,
                                      serve_prompts)
            rec.update(serve=toks, snapshot=snap, serve_launches={
                n: w.launches for n, w in wrappers.items()})
    if card:
        torch.cuda.synchronize()
    rec.update(wall_s=time.perf_counter() - t0, layout=layout.summary(),
               vocab_split=layout.vocab == "split",
               collectives=layout.collectives(cfg.num_layers, cfg.act_bits),
               reduce_o=layout.reduce_o, reduce_mlp=layout.reduce_mlp,
               gather_o=layout.o == "gather",
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if card
               else 0.0)
    if card:
        torch.cuda.empty_cache()
    return rec


def join_logits(torch, per, shape, vocab_split):
    """The global logits of every rank's piece: a data group's model ranks
    joined on the vocabulary (where it splits), the groups on the rows."""
    dp, tp = shape
    rows = []
    for d in range(dp):
        mine = [p["logits"] for p in per[d * tp:(d + 1) * tp]]
        rows.append(torch.cat(mine, dim=-1) if vocab_split else mine[0])
    return torch.cat(rows, dim=0)


def uneven_check(torch, label, shape, per, ref):
    """One 7c job's rule (phase 7's): every rank's tokens equal; the
    joined first decode step's (or [sp prefill]'s) logits within the
    bound of the single-rank run; each greedy token equal to the
    single-rank run's or parting at a near-tie (its margin below the
    bound); the collectives as the layout's formula gives them; the
    serving engine's requests by length with prefix hits.  Prints each
    rank's launches, peak memory and the job's seconds."""
    dp, tp = shape
    p0 = per[0]
    print(f"[{label}] layout: {p0['layout']} | wall {p0['wall_s']:.1f} s | "
          f"peak memory a rank "
          f"{[round(p['peak_gb'], 2) for p in per]} GB", flush=True)
    got = join_logits(torch, per, shape, p0["vocab_split"])
    want = ref["logits"]
    if got.shape != want.shape or not bool(got.isfinite().all()):
        fail(f"[{label}]: logits {tuple(got.shape)} not finite or not "
             f"{tuple(want.shape)}")
    err = (got - want).abs().max().item()
    if not err <= ref["bound"]:
        fail(f"[{label}]: logits {err} from the single-rank run, > "
             f"{ref['bound']}")
    out = dict(max_abs_diff=err, bound=ref["bound"], wall_s=p0["wall_s"],
               peak_gb=[p["peak_gb"] for p in per], layout=p0["layout"])
    if label.startswith("sp prefill"):
        L = UNEVEN_CUT
        want_calls = {
            "all_gather": 2 * L + L * p0["gather_o"] + p0["vocab_split"],
            "reduce_scatter": L * (p0["reduce_o"] + p0["reduce_mlp"])
            + p0["vocab_split"], "all_reduce": 1}
        for r, p in enumerate(per):
            calls = {n: p["launches"][n] for n in want_calls}
            if calls != want_calls or p["tokens_shape"] != (2, SP_T // tp):
                fail(f"[{label}] rank {r}: collectives {calls} (want "
                     f"{want_calls}), tokens {p['tokens_shape']}")
        print(f"[sp prefill] tp={tp}: Qwen2.5-3B bf16, {L} layers (of 36, "
              f"cut for time), 2 x {SP_T} tokens, {SP_T // tp} a "
              f"rank | last tokens' logits vs the unsharded prefill max |d| "
              f"{err:.4g} (bound {ref['bound']:.4g}) | a rank's collectives "
              f"{want_calls}", flush=True)
        return dict(out, collectives=want_calls)
    toks = [p["tokens"] for p in per]
    if any(t != toks[0] for t in toks):
        fail(f"[{label}]: the ranks' tokens differ")
    same, ties = margin_parts(label, "tp", dict(enumerate(toks[0])),
                              dict(enumerate(ref["generate"][0])),
                              ref["generate"][1], ref["bound"])
    if not all(t["near_tie"] for t in ties):
        fail(f"[{label}]: a part from the single-rank run is not a near-tie "
             f"{ties}")
    forwards = p0["steps"]
    ar, ag = p0["collectives"]["all_reduce"], p0["collectives"]["all_gather"]
    # the sampler's two gathers a forward on a split vocabulary; under a
    # data axis the rows' and the step counts' gathers at the end
    must = {"all_reduce": ar * forwards,
            "all_gather": (ag + 2 * p0["vocab_split"]) * forwards
            + 2 * (dp > 1)}
    for r, p in enumerate(per):
        wrong = {n: p["launches"][n] for n, c in must.items()
                 if p["launches"][n] != c}
        if wrong or p["launches"]["flash_attention"] <= 0:
            fail(f"[{label}] rank {r}: collectives {wrong} (want {must})")
    n_tok = 4 * TP_NEW
    out.update(tokens_equal_single=same, tokens=n_tok, parts=ties,
               collectives=must, ttft_ms=p0["ttft_ms"],
               decode_tok_s=p0["decode_tok_s"])
    line = (f"[{label}] dp={dp} tp={tp}: batch 4 {TP_LENS}, {TP_NEW} tokens,"
            f" gloo ranks sharing the card (eager steps) | first decode "
            f"step's logits vs the single-rank run max |d| {err:.4g} (bound "
            f"{ref['bound']:.4g}) | tokens equal on every rank, equal to "
            f"the single-rank run {same}/{n_tok} ({len(ties)} near-ties) | "
            f"a forward's collectives {p0['collectives']} + the sampler's "
            f"gathers | ttft {p0['ttft_ms']:.1f} ms, "
            f"{p0['decode_tok_s']:.1f} tok/s (not a TP speed)")
    if "serve" in p0:
        served = [p["serve"] for p in per]
        if any(t != served[0] for t in served):
            fail(f"[{label}]: the ranks' served tokens differ")
        bad = [k for k, (why, ids) in served[0].items()
               if why != "length" or len(ids) != TP_SERVE_NEW]
        if len(served[0]) != 6 or bad:
            fail(f"[{label}]: {len(served[0])} of 6 requests, not by length:"
                 f" {bad}")
        s_same, s_ties = margin_parts(
            label + " serve", "tp",
            {k: t for k, (_, t) in served[0].items()},
            {k: t for k, (_, t) in ref["serve"].items()},
            ref["serve_margins"], ref["bound"])
        if not all(t["near_tie"] for t in s_ties):
            fail(f"[{label}] serve: a part from the single-rank scheduler is "
                 f"not a near-tie {s_ties}")
        hits = p0["snapshot"]["prefix_hit_tokens"]
        if hits < 2 * TP_SERVE_SHARED:
            fail(f"[{label}] serve: prefix hits {hits}")
        for r, p in enumerate(per):
            print(f"[{label}] serve rank {r} launches "
                  f"{ {n: c for n, c in p['serve_launches'].items() if c} }",
                  flush=True)
        line += (f" | serving 6 requests on 4 slots (2 sharing "
                 f"{TP_SERVE_SHARED} tokens), bf16 pool: equal on every "
                 f"rank, to the single-rank scheduler {s_same}/"
                 f"{6 * TP_SERVE_NEW} ({len(s_ties)} near-ties), prefix hits "
                 f"{hits}")
        out.update(serve_equal_single=s_same, serve_parts=s_ties,
                   prefix_hit_tokens=hits)
    print(line, flush=True)
    return out


# ----------------------------------------------------------------------
# 8. expert parallelism: gloo ranks sharing the card, Qwen3-30B-A3B width
# ----------------------------------------------------------------------

EP_DECODE_TOKENS = 16      # a rank's tokens at decode (x top-8 = 128 rows)
EP_PIECE_TOKENS = 2048     # a rank's tokens at a piece (16384 rows)
EP_SERVE_LENS = [300, 700, 100, 200, 900, 150, 250, 600]  # slots 1 and 4:
                           # interior pieces on both ranks at once
EP_SERVE_ECHO = [100, 200, 300, 400, 500, 600, 700, 900]
# [ep serve]'s depth: the ranks' gloo all-to-alls and gathers stage through
# the host three times a layer, so a run's time grows with the depth (a
# world of 2 ranks took 62.9 s at 12 layers in an H100 run whose phases
# 1-7 took 810 s); the whole smoke must stay within its 900 s
EP_LAYERS = 4
EP_CUT = (f"depth cut to {EP_LAYERS} of 48 layers for time (gloo's host "
          f"round trips, three a layer a step)")
# [ep serve]'s runs: (label, traffic, pool dtype name, prompt lookup)
EP_SERVE_RUNS = (("bf16", "plain", "bfloat16", False),
                 ("pld", "echo", "bfloat16", True),
                 ("int8", "plain", "int8", False))


def check_ep_grouped(torch, cfg):
    """The three grouped kernels at the shard shapes the EP layer gives
    them (``parallel/ep_moe.py``): a rank's ``e_loc`` = 64 / 32 experts
    (ep 2 / 4) over its receive buffer of P * M rows, M = tokens x top-8 of
    one rank (16 tokens at decode, 2048 at a piece), of which only the
    pairs routed to its experts are real; the rows past the last group
    are uncovered.  Gate / up (K 2048, N 768, INT4 gs 256) and down (K 768,
    N 2048, INT4 gs 128; INT8 per group of 128 rows), layer 1 of a stacked
    [2, e_loc, ...] tensor; the output prefilled with NaN (``out``), which
    the kernel must leave in every uncovered row; the covered rows against
    the plain version (the grouped rule, 2^-6 of the largest output),
    timed beside the plain version and ``torch._grouped_mm`` over the
    covered rows, with the bound of the covered rows.  Returns {kernel:
    [records]}."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.ops.linear import (
        QuantLinear,
        dequantize,
    )
    from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
        quantize_activations,
    )

    E, k = cfg.num_experts, cfg.num_experts_per_tok
    D, Fm = cfg.hidden_size, cfg.moe_intermediate_size
    g = torch.Generator(device="cuda").manual_seed(25)
    L, layer = 2, 1
    records = {n: [] for n in GROUPED}
    for ep in (2, 4):
        e_loc = E // ep
        for what, tokens in (("decode", EP_DECODE_TOKENS),
                             ("piece", EP_PIECE_TOKENS)):
            rows = ep * tokens * k
            # every rank's tokens routed by random top-8; this rank (0)
            # receives the pairs of its experts
            gsz = _routing(torch, g, ep * tokens, E, k)[:e_loc].contiguous()
            real = int(gsz.sum())
            for proj, K, N, gs4 in (("gate", D, Fm, 256),
                                    ("down", Fm, D, 128)):
                x = torch.randn((rows, K), generator=g,
                                device="cuda").to(torch.bfloat16)
                xq, sx = quantize_activations(x)
                sx = sx.reshape(-1).contiguous()
                weights = {
                    4: (torch.randint(-128, 128, (L, e_loc, K // 2, N),
                                      generator=g, device="cuda",
                                      dtype=torch.int8),
                        torch.rand((L, e_loc, K // gs4, N), generator=g,
                                   device="cuda") * (2 * K ** -0.5 / 7), gs4),
                    8: (torch.randint(-127, 128, (L, e_loc, K, N), generator=g,
                                      device="cuda", dtype=torch.int8),
                        torch.rand((L, e_loc, K // 128, N), generator=g,
                                   device="cuda") * (2 * K ** -0.5 / 127),
                        128)}
                for name, (bits, act_bits, peak) in GROUPED.items():
                    q, s, gs = weights[bits]
                    fn, plain = getattr(gm, name), getattr(gm, name + "_plain")
                    if act_bits:
                        args = (xq, sx, q, s, gsz, layer, gs)
                    elif bits == 4:
                        args = (x, q, s, gsz, layer, gs)
                    else:
                        args = (x, q, s, gsz, layer)
                    out = torch.full((rows, N), float("nan"),
                                     dtype=torch.bfloat16, device="cuda")
                    got = fn(*args, out=out)
                    ref = plain(*args)
                    torch.cuda.synchronize()
                    err = (got[:real].float() - ref[:real].float()).abs() \
                        .max().item()
                    tol = GROUPED_TOL * ref[:real].float().abs().max().item()
                    tail = bool(got[real:].isnan().all())
                    shape = (f"ep={ep} e_loc={e_loc} {what} {proj} rows "
                             f"{rows} (covered {real}) K={K} N={N} gs {gs}")
                    if not (err <= tol and tail
                            and bool(got[:real].isfinite().all())):
                        fail(f"{name} {shape}: err {err} > {tol}, or a "
                             f"covered row not finite, or the uncovered "
                             f"tail written ({not tail})")
                    ms = time_ms(torch, lambda: fn(*args))
                    plain_ms = time_ms(torch, lambda: plain(*args), iters=3,
                                       warmup=1)
                    w = dequantize(QuantLinear(q=q[layer], scales=s[layer],
                                               b=None, bits=bits,
                                               group_size=gs))
                    lib, lib_label = _grouped_library(torch, x[:real], w, gsz)
                    lib_ms = time_ms(torch, lib)
                    del w
                    touched = int((gsz > 0).sum())
                    wrows = K // 2 if bits == 4 else K
                    n_bytes = (touched * (wrows * N + 4 * s.shape[2] * N)
                               + real * K * (1 if act_bits else 2)
                               + 4 * real * (act_bits > 0) + 2 * real * N
                               + 4 * e_loc)
                    b_ms, b_by = bound(n_bytes, 2 * real * K * N, peak)
                    print(f"  [ep shards] {name} {shape}: err {err:.3g} (tol "
                          f"{tol:.3g}) | uncovered rows still NaN {tail} | "
                          f"kernel {ms:.4f} ms | plain {plain_ms:.4f} | "
                          f"{lib_label} {lib_ms:.4f} | bound {b_ms:.4f} "
                          f"({b_by})", flush=True)
                    records[name].append(dict(
                        shape=shape, ep=ep, e_loc=e_loc, what=what, proj=proj,
                        rows=rows, covered=real, max_abs_err=err, tol=tol,
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        library=lib_label, bound_ms=b_ms, bound_by=b_by))
                del x, xq, sx, weights
                torch.cuda.empty_cache()
    return records


def ep_layer_record(recs):
    """A grouped kernel's EP entry: a layer's gate + up + down at each
    (ep, decode / piece) shard shape, summed as ``moe_layer_record``."""
    out = {}
    for ep in (2, 4):
        for what in ("decode", "piece"):
            by = {r["proj"]: r for r in recs
                  if r["ep"] == ep and r["what"] == what}
            out[f"ep{ep}_{what}"] = dict(
                rows=by["gate"]["rows"], e_loc=by["gate"]["e_loc"],
                **{key: 2 * by["gate"][key] + by["down"][key]
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
    return out


def ep_moe_params(torch, cfg, layers):
    """Qwen3-30B-A3B W4A8 gs 256 at full width and ``layers`` depth, the
    same seeded draw in every process (``moe_params`` on the current
    card)."""
    return (cfg.replace(num_layers=layers, act_bits=8),
            moe_params(torch, cfg, 4, 256, layers))


def ep_moe_case(torch, cfg, params, mesh, tokens, wrappers):
    """[ep moe] on this rank: ``ep_moe_layer`` of its ``tokens`` rows of a
    seeded batch (the same on every rank) over its experts of layer 0, in
    the ragged and the dense form and once more with every grouped
    kernel's output prefilled with NaN (``out``); the single-rank
    ``moe_mlp`` over the whole batch.  Returns numbers (the main process
    checks them)."""
    from qwen_inference_engine_tpu_torch.models.qwen import moe_mlp
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.parallel import mesh as pmesh
    from qwen_inference_engine_tpu_torch.parallel.ep_moe import ep_moe_layer
    from qwen_inference_engine_tpu_torch.parallel.ep_step import (
        ep_param_shards,
    )

    P, r = mesh.ep, mesh.rank
    lyr = params["layers"]
    local = ep_param_shards(params, mesh)["layers"]
    g = torch.Generator(device="cuda").manual_seed(80 + tokens)
    h = torch.randn((P * tokens, cfg.hidden_size), generator=g,
                    device="cuda").to(torch.bfloat16)
    h_l = h[r * tokens:(r + 1) * tokens]
    args = (h_l, lyr["router"].w[0], local["moe_gate"], local["moe_up"],
            local["moe_down"], cfg.num_experts_per_tok, cfg.norm_topk_prob,
            mesh.ep_group)
    kw = dict(layer=0, act_bits=8)
    for w in wrappers.values():
        w.launches = 0
    with torch.inference_mode():
        ragged = ep_moe_layer(*args, ragged=True, **kw)
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in wrappers.items() if c.launches}
        dense = ep_moe_layer(*args, ragged=False, **kw)
        orig, tails = gm.grouped_matmul4_a8, []

        def poisoned(xq, sx, q, s, gsz, layer, gs):
            out = torch.full((xq.shape[0], q.shape[-1]), float("nan"),
                             dtype=torch.bfloat16, device=xq.device)
            y = orig(xq, sx, q, s, gsz, layer, gs, out=out)
            tails.append(bool(y[int(gsz.sum()):].isnan().all()))
            return y

        # the wrapper counts its launches on the module's name
        poisoned.launches = orig.launches
        with Swapped([(gm, "grouped_matmul4_a8", poisoned)]):
            nan_tail = ep_moe_layer(*args, ragged=True, **kw)
        ref = moe_mlp(h, lyr["router"].w[0], lyr["moe_gate"], lyr["moe_up"],
                      lyr["moe_down"], cfg.num_experts_per_tok,
                      cfg.norm_topk_prob, **kw)[r * tokens:(r + 1) * tokens]

        def host_ms(ragged_form, n=3):
            pmesh.all_reduce(torch.zeros(1, device="cuda"), mesh.ep_group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                ep_moe_layer(*args, ragged=ragged_form, **kw)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        ms_ragged, ms_dense = host_ms(True), host_ms(False)
    return dict(
        ragged_eq_dense=bool(torch.equal(ragged, dense)),
        nan_tail_eq=bool(torch.equal(nan_tail, ragged)),
        nan_tail_finite=bool(nan_tail.isfinite().all()),
        tails=tails, counts=counts,
        err=(ragged.float() - ref.float()).abs().max().item(),
        ref_max=ref.float().abs().max().item(),
        bit_equal_single=bool(torch.equal(ragged, ref)),
        ms_ragged=ms_ragged, ms_dense=ms_dense)


def ep_serve_requests(rng, vocab):
    """[ep serve]'s traffic: 8 random prompts (two longer than two pieces,
    on slots of different ranks) and 8 echo prompts for prompt lookup."""
    return ([rng.integers(0, vocab, size=n).tolist() for n in EP_SERVE_LENS],
            echo_prompts(rng, vocab, EP_SERVE_ECHO))


def ep_serve_run(torch, cfg, params, mesh, prompts, kv_dtype, spec,
                 wrappers, recorder=None):
    """The serving engine on 8 slots over pages of 512 (pieces of 256,
    prefix cache off: EP switches it off), EOS off, greedy: ``prompts``
    drained with 32 new tokens each.  Its launches counted from 0 just
    before the run and read just after.  Returns (tokens by request,
    numbers)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, mesh=mesh, max_slots=8, page_size=PAGE, num_pages=24,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=False,
        sampling=SamplingParams(greedy=True), kv_dtype=kv_dtype,
        speculative=spec, spec_k=SPEC_K, spec_ngram=3, device="cuda")
    cb._eos = set()
    batched = [0]
    if mesh is not None:
        tick = cb._ep_prefill_batch_tick

        def counted(prefilling):
            did = tick(prefilling)
            batched[0] += did
            return did
        cb._ep_prefill_batch_tick = counted
    if recorder is not None:
        recorder.attach(cb)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=NEW_TOKENS))
    done = cb.run_to_completion(sync_every=8)
    cb.check_page_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = cb.metrics.snapshot()
    toks = {f.request_id: f.token_ids for f in done}
    if len(done) != len(prompts) or any(
            f.finish_reason != "length" or len(f.token_ids) != NEW_TOKENS
            for f in done):
        fail(f"[ep serve]: a request did not finish by length")
    del cb
    torch.cuda.empty_cache()
    return toks, dict(wall_s=wall, batched_piece_ticks=batched[0],
                      launches={n: w.launches for n, w in wrappers.items()},
                      **snap)


def ep_first_tick(torch, cfg, params, mesh, prompts):
    """The logits of one decode tick of 8 slots after every prompt's
    prefill (each piece on every rank under EP), bf16 pool: ``[8, V]``,
    the ranks' rows gathered."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, mesh=mesh, max_slots=8, page_size=PAGE, num_pages=24,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=False,
        sampling=SamplingParams(greedy=True), device="cuda")
    cb._eos = set()
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=NEW_TOKENS))
    with torch.inference_mode():
        while cb._try_admit():
            pass
        for run in list(cb._slots):
            while not run.prefill_done:
                cb._prefill_tick(run)
        cb._load_tick([s for s in cb._slots if s is not None])
        t = cb._tick
        logits, _ = cb._decode_fn(cb.params, t.tok, t.pos, cb.cache, t.tables)
        logits = logits.float().cpu()
    del cb
    torch.cuda.empty_cache()
    return logits


def ep_rank(rank, world_size, layers, serve, moe_tokens):
    """One rank of a gloo world on the card: [ep moe] at ep = the world's
    size (each of ``moe_tokens`` a rank), then, with ``serve`` (its
    prompts), [ep serve]: the bf16 pool, prompt lookup on echo traffic,
    the INT8 pool and the logits of a first decode tick.  Returns
    {label: numbers}."""
    import torch

    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.parallel.mesh import make_ep_mesh
    from qwen_inference_engine_tpu_torch.utils.metrics import (
        counted_wrappers,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_ep_mesh()
    wrappers = counted_wrappers()
    base = PRESETS["qwen3-30b-a3b"]
    out = {}
    cfg, params = ep_moe_params(torch, base, 1)
    for tokens in moe_tokens:
        out[f"moe {tokens}"] = ep_moe_case(torch, cfg, params, mesh, tokens,
                                           wrappers)
    del params
    torch.cuda.empty_cache()
    if serve is None:
        return out
    plain, echo = serve
    cfg, params = ep_moe_params(torch, base, layers)
    t0 = time.perf_counter()
    for label, prompts, kv, spec in EP_SERVE_RUNS:
        toks, nums = ep_serve_run(torch, cfg, params, mesh,
                                  plain if prompts == "plain" else echo,
                                  getattr(torch, kv), spec, wrappers)
        out[f"serve {label}"] = dict(tokens=toks, **nums)
    out["first tick"] = ep_first_tick(torch, cfg, params, mesh, plain)
    out["serve_s"] = time.perf_counter() - t0
    return out


def tie_gap(torch, cfg, params, prompt, a, b):
    """The single-rank logit gap between tokens ``a`` and ``b`` after
    ``prompt`` (one prefill of it on the kernel path, bf16 KV): logit[a] -
    logit[b], and the argmax."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models import qwen

    T = len(prompt)
    cache = KVCache.create(cfg.num_layers, 1, -(-T // 512) * 512,
                           cfg.num_kv_heads, cfg.head_dim, device="cuda")
    with torch.inference_mode():
        logits, _ = qwen.prefill_chunked(
            params, cfg, torch.tensor([prompt], device="cuda"),
            torch.tensor([T], device="cuda"), cache, chunk=512)
    row = logits[0].float()
    return (row[a] - row[b]).item(), int(row.argmax())


def ep_serve_check(torch, label, per, ref, prompts, cfg, params, bound):
    """One [ep serve] run's rule: every rank's tokens equal; each request's
    greedy tokens equal to the single-rank scheduler's, or, from its first
    differing position, a near-tie: the single-rank logit gap between the
    two candidates there below ``bound``.  Returns the numbers."""
    toks = [p["tokens"] for p in per]
    if any(t != toks[0] for t in toks):
        fail(f"[ep serve {label}]: the ranks' tokens differ")
    same, ties = 0, []
    for rid, want in ref.items():
        got = toks[0][rid]
        i = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        if i is None:
            same += len(want)
            continue
        same += i
        gap, top = tie_gap(torch, cfg, params, prompts[rid] + want[:i],
                           want[i], got[i])
        ties.append(dict(request=rid, position=i, single=want[i], ep=got[i],
                         gap=gap, single_argmax=top))
        print(f"[ep serve {label}] request {rid} parts from the single-rank "
              f"run at token {i}: single {want[i]}, ep {got[i]}, single-rank "
              f"logit gap {gap:.4g} (bound {bound:.4g})", flush=True)
        if not abs(gap) < bound:
            fail(f"[ep serve {label}]: request {rid} token {i} differs with "
                 f"a logit gap {gap} >= {bound}: not a near-tie")
    return same, ties


def run_ep_phases(torch, np, wrappers, layers=EP_LAYERS):
    """[ep moe] at ep 2 and 4 and [ep serve] at ep 2 in gloo worlds of
    ranks sharing the card, each against the single-rank port on the same
    seeded params.  The ranks time-share the card's SMs and exchange
    through the host: no number here is an EP speed.  Returns (every
    rank's launches summed, the numbers)."""
    from qwen_inference_engine_tpu_torch.config import PRESETS

    base = PRESETS["qwen3-30b-a3b"]
    rng = np.random.default_rng(25)
    plain, echo = ep_serve_requests(rng, base.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {n: 0 for n in wrappers}
    numbers = {}
    ranks = {}
    # both worlds at once: their ranks time-share the card
    done = spawn_worlds([(ep_rank, world, (layers, serve, (
        EP_DECODE_TOKENS, EP_PIECE_TOKENS)))
        for world, serve in ((2, (plain, echo)), (4, None))])
    for world in (2, 4):
        ranks[world], wall = done[world]
        print(f"[ep] a gloo world of {world} ranks on the card: {wall:.1f} s "
              f"(spawn, params, runs; beside the other world)", flush=True)
    # [ep moe]: the layer's rules at both sizes
    for world, per in ranks.items():
        for tokens in (EP_DECODE_TOKENS, EP_PIECE_TOKENS):
            res = [p[f"moe {tokens}"] for p in per]
            want = {"grouped_matmul4_a8": 3, "all_to_all": 2,
                    "all_gather": 1}
            for r, x in enumerate(res):
                tol = GROUPED_TOL * x["ref_max"]
                print(f"[ep moe] ep={world} rank {r}, {tokens} tokens a rank "
                      f"({tokens * 8} pairs), 30B-A3B layer W4A8 gs 256: "
                      f"ragged = dense bit for bit {x['ragged_eq_dense']} | "
                      f"grouped outputs' uncovered rows NaN before the call "
                      f"and after {all(x['tails'])}, combine finite "
                      f"{x['nan_tail_finite']} and bit-equal "
                      f"{x['nan_tail_eq']} | vs moe_mlp on one rank over the "
                      f"whole batch max |d| {x['err']:.4g} (tol {tol:.4g}; "
                      f"bit-equal {x['bit_equal_single']}) | launches a "
                      f"layer {x['counts']} | host ms a layer ragged "
                      f"{x['ms_ragged']:.2f}, dense {x['ms_dense']:.2f} "
                      f"(ranks share the card)", flush=True)
                bad = {n: x["counts"].get(n, 0) for n, c in want.items()
                       if x["counts"].get(n, 0) != c}
                if not (x["ragged_eq_dense"] and x["nan_tail_eq"]
                        and x["nan_tail_finite"] and all(x["tails"])
                        and len(x["tails"]) == 3 and x["err"] <= tol
                        and not bad):
                    fail(f"[ep moe] ep={world} rank {r} {tokens} tokens: "
                         f"{x} (launches off {bad})")
                for n in launches:      # the kernels' (main's wrappers)
                    launches[n] += x["counts"].get(n, 0)
            numbers[f"moe ep{world} {tokens}"] = res
    # [ep serve]: the single-rank scheduler on the same params and traffic
    per = ranks[2]
    cfg, params = ep_moe_params(torch, base, layers)
    ref = {label: ep_serve_run(torch, cfg, params, None,
                               plain if traffic == "plain" else echo,
                               getattr(torch, kv), spec, wrappers)[0]
           for label, traffic, kv, spec in EP_SERVE_RUNS}
    tick8 = ep_first_tick(torch, cfg, params, None, plain)
    tick16 = ep_first_tick(torch, cfg.replace(act_bits=0), params, None,
                           plain)
    a8_vs_a16 = (tick8 - tick16).abs().max().item()
    bound = 2 * a8_vs_a16
    for r, p in enumerate(per):
        got = p["first tick"]
        if got.shape != tick8.shape or not bool(got.isfinite().all()):
            fail(f"[ep serve] rank {r}: first tick's logits "
                 f"{tuple(got.shape)} not finite or not {tuple(tick8.shape)}")
    err = max((p["first tick"] - tick8).abs().max().item() for p in per)
    print(f"[ep serve] ep=2, 30B-A3B W4A8 gs 256, {layers} layers "
          f"({EP_CUT}), bf16 pool, "
          f"8 slots: a first decode tick's logits (the ranks' rows gathered) "
          f"vs the single-rank scheduler's max |d| {err:.4g} (bound: 2 x the "
          f"single-rank W4A8 vs W4A16 distance = {bound:.4g})", flush=True)
    if not err <= bound:
        fail(f"[ep serve]: first tick's logits {err} from the single-rank "
             f"run, > {bound}")
    numbers["serve"] = dict(first_tick_max_abs_diff=err, bound=bound,
                            a8_vs_a16=a8_vs_a16, layers=layers,
                            serve_s=per[0]["serve_s"])
    sfx = {"bf16": "", "pld": "", "int8": "_q8"}
    for label, traffic, kv, spec in EP_SERVE_RUNS:
        runs = [p[f"serve {label}"] for p in per]
        prompts = plain if traffic == "plain" else echo
        same, ties = ep_serve_check(torch, label, runs, ref[label], prompts,
                                    cfg, params, bound)
        must = {"grouped_matmul4_a8", "quant_matmul4_a8", "flash_attention",
                "paged_append_prefill", "all_to_all", "all_gather",
                "all_reduce"}
        must |= ({"paged_verify_attention_stacked", "paged_append_ragged_t"}
                 if spec else {"paged_decode_attention_stacked" + sfx[label],
                               "paged_append_ragged",
                               "paged_chunk_attention" + sfx[label]})
        for r, run in enumerate(runs):
            cnt = run["launches"]
            print(f"[ep serve {label}] rank {r} launches "
                  f"{ {n: c for n, c in cnt.items() if c} }", flush=True)
            missing = sorted(n for n in must if cnt[n] <= 0)
            if missing:
                fail(f"[ep serve {label}] rank {r}: not launched {missing}")
            for n in launches:
                launches[n] += cnt[n]
        run = runs[0]
        n_tok = NEW_TOKENS * len(prompts)
        print(f"[ep serve {label}] ep=2, {layers} layers, 8 slots, "
              f"{'echo ' if traffic == 'echo' else ''}prompts "
              f"{[len(x) for x in prompts]}, {NEW_TOKENS} new: tokens equal "
              f"on every rank | greedy tokens equal to the single-rank "
              f"scheduler {same}/{n_tok} ({len(ties)} near-ties) | batched "
              f"interior-piece ticks {run['batched_piece_ticks']} | spec "
              f"rounds {run['spec_rounds']}, tokens per forward "
              f"{run['spec_tokens_per_forward']:.3f} | TTFT p50 "
              f"{run['ttft_p50_s'] * 1e3:.1f} ms, decode "
              f"{run['decode_tokens_per_s']:.1f} tok/s, wall "
              f"{run['wall_s']:.2f} s (not an EP speed: the ranks share the "
              f"card)", flush=True)
        if label == "bf16" and run["batched_piece_ticks"] <= 0:
            fail("[ep serve bf16]: the batched interior pieces did not run")
        if spec and run["spec_rounds"] <= 0:
            fail("[ep serve pld]: no speculation round ran")
        numbers[f"serve {label}"] = dict(
            tokens_equal_single=same, tokens=n_tok, near_ties=ties,
            batched_piece_ticks=run["batched_piece_ticks"],
            spec_rounds=run["spec_rounds"],
            spec_tokens_per_forward=run["spec_tokens_per_forward"],
            ttft_p50_s=run["ttft_p50_s"],
            decode_tokens_per_s=run["decode_tokens_per_s"],
            wall_s=run["wall_s"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


# ----------------------------------------------------------------------
# 9. pipeline parallelism: gloo ranks sharing the card, Qwen2.5-7B W4A8
# ----------------------------------------------------------------------

PP_LAYERS = 28
PP_FORWARD_LENS = [37, 100, 200, 256]   # [pp forward]: ragged prefill
PP_FORWARD_STEPS = 4                    # then per-tick decode steps
PP_SEQ = 512                            # [pp forward] / [pp serve] caches
# [pp serve]'s depth, a multiple of 4 layers: the ranks' eager ticks and
# gloo exchanges grow with it, and the whole smoke must stay in its limit
PP_SERVE_LAYERS = 8
PP_SERVE_CUT = (f"depth cut to {PP_SERVE_LAYERS} of 28 layers for time "
                f"(eager stage ticks and gloo round trips)")
PP_SERVE_NEW = 16
PP_SERVE_RAGGED = [37, 64, 100, 128, 150, 180, 200, 240]
# greedy rows with a repetition penalty that rules out every seen token
PP_PEN = dict(greedy=True, repetition_penalty=1e6, presence_penalty=0.5)
PP_STOCH = dict(temperature=0.8, top_k=50, top_p=0.9)
# [pp serve]'s waves: (label, prompts kind, per-row sampling)
PP_WAVES = (("greedy", "aligned", None), ("sampled", "aligned", "mixed"),
            ("penalized", "aligned", "pen"), ("ragged", "ragged", None))


def pp_wave_sampling(kind, i):
    """Request i's sampling in a wave of ``kind``: None (the scheduler's
    greedy default), every other row sampled, or the penalty rows."""
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    if kind == "mixed":
        return SamplingParams(**(PP_STOCH if i % 2 else dict(greedy=True)))
    if kind == "pen":
        return SamplingParams(**PP_PEN)
    return None


def pp_rank(rank, world_size, layers, fwd, f1b, serve):
    """One stage of a gloo world on the card: the same seeded 7B W4A8 gs 64
    params in every process, this stage's layers kept.  [pp forward]: a
    prefill of ``fwd``'s ragged prompts, then its decode steps (the tokens
    given); [pp 1f1b]: an aligned prefill of ``f1b``'s prompts, then the
    1F1B decode, zero-copy and sliced, over a bf16 and an INT8 cache;
    [pp serve]: ``PPFifoScheduler`` at ``serve``'s depth over both caches,
    its waves in turn.  Launches counted from 0 just before each run and
    read just after.  Returns {label: numbers}."""
    import torch

    from qwen_inference_engine_tpu_torch.engine.pp_scheduler import (
        PPFifoScheduler,
    )
    from qwen_inference_engine_tpu_torch.engine.types import Request
    from qwen_inference_engine_tpu_torch.models.qwen import map_params
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.parallel import pp_step
    from qwen_inference_engine_tpu_torch.parallel.mesh import make_pp_mesh
    from qwen_inference_engine_tpu_torch.utils.metrics import (
        counted_wrappers,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = tp_model(torch, layers)
    dev = params["embed"].device
    mesh = make_pp_mesh(world_size)
    S, me = mesh.stages, mesh.stage
    wrappers = counted_wrappers()

    def reset():
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {n: w.launches for n, w in wrappers.items()}

    serve_params = dict(params, layers=map_params(
        params["layers"], lambda t: t[:serve["layers"]].clone()))
    params_l, _ = pp_step.shard_for_pp(params, None, mesh)
    del params
    out = {}
    # [pp forward]
    prompts, lens, toks = (torch.tensor(x, device=dev) for x in fwd)
    B, T = prompts.shape
    cache = pp_step.pp_cache(cfg, mesh, B, PP_SEQ, device=dev)
    pre = pp_step.make_pp_forward_fn(cfg, mesh)
    reset()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache = pre(params_l, prompts,
                            torch.arange(T, device=dev)[None].expand(B, T),
                            lens, cache)
        got = [logits.float().cpu()]
        for s, tok in enumerate(toks):
            logits, cache = pre(params_l, tok[:, None], (lens + s)[:, None],
                                lens, cache)
            got.append(logits.float().cpu())
    out["forward"] = dict(logits=got, launches=counts(),
                          wall_s=time.perf_counter() - t0)
    del cache
    # [pp 1f1b]
    prompts = torch.tensor(f1b, device=dev)
    B, T = prompts.shape
    b = B // S
    for kv in ("bfloat16", "int8"):
        cache = pp_step.pp_cache(cfg, mesh, B, PP_1F1B_SEQ,
                                 dtype=getattr(torch, kv), device=dev)
        with torch.inference_mode():
            logits, cache = pre(params_l, prompts,
                                torch.arange(T, device=dev)[None].expand(B, T),
                                torch.full((B,), T, device=dev), cache)
        first = torch.argmax(logits, dim=-1)
        runs = {}
        for zero_copy in (True, False):
            c = type(cache)(*(None if t is None else t.clone() for t in (
                cache.k, cache.v, cache.k_scale, cache.v_scale)))
            fn = pp_step.make_pp_decode_1f1b(cfg, mesh, microbatch_rows=b,
                                             steps=PP_STEPS,
                                             zero_copy_cache=zero_copy)
            reset()
            t0 = time.perf_counter()
            with torch.inference_mode():
                ys, c = fn(params_l, first.reshape(S, b), [T] * S, c)
            runs[zero_copy] = (ys, c, counts(), time.perf_counter() - t0)
        (yz, cz, nz, wz), (ysl, csl, _, wsl) = runs[True], runs[False]
        caches_equal = all(
            (a is None and c is None) or bool(torch.equal(a, c)) for a, c in
            zip((cz.k, cz.v, cz.k_scale, cz.v_scale),
                (csl.k, csl.v, csl.k_scale, csl.v_scale)))
        tokens = torch.cat([first[None], yz.reshape(PP_STEPS, B)]).T
        out[f"1f1b {kv}"] = dict(
            tokens=tokens.cpu().tolist(),
            tokens_equal=bool(torch.equal(yz, ysl)),
            caches_equal=caches_equal, launches=nz, wall_zero_copy_s=wz,
            wall_sliced_s=wsl, ticks=S + PP_STEPS * S)
        del cache, runs, cz, csl
        torch.cuda.empty_cache()
    del params_l, pre
    # [pp serve]
    cfg_s = cfg.replace(num_layers=serve["layers"])
    for kv in ("bfloat16", "int8"):
        pp = PPFifoScheduler(cfg_s, serve_params, mesh=mesh,
                             max_batch=PP_WAVE, max_seq=PP_SEQ,
                             kv_dtype=getattr(torch, kv),
                             sampling=SamplingParams(greedy=True), seed=26,
                             device=dev)
        pp._eos = set()    # random weights can argmax onto EOS
        for label, kind, sp in PP_WAVES:
            reset()
            t0 = time.perf_counter()
            for i, p in enumerate(serve[kind]):
                pp.submit(Request(request_id=i, prompt=p,
                                  max_new_tokens=PP_SERVE_NEW,
                                  sampling=pp_wave_sampling(sp, i)))
            with torch.inference_mode():
                done = pp.run_to_completion(sync_every=8)
            out[f"serve {kv} {label}"] = dict(
                tokens={f.request_id: f.token_ids for f in done},
                reasons={f.request_id: f.finish_reason for f in done},
                fns=sorted(pp._fns), launches=counts(),
                wall_s=time.perf_counter() - t0)
        del pp
        torch.cuda.empty_cache()
    return out


def pp_tokens_check(torch, label, got, want, prompts, cfg, params, bound,
                    same_path=None):
    """Each request's greedy tokens equal to the single-rank run's, or,
    from its first differing position, a near-tie: the single-rank logit
    gap between the two candidates there below ``bound``; or, given
    ``same_path`` (one rank's tokens through the kernels the stages run, on
    the same rows and shapes), bit-equal to those: the part is then one
    rank's own rounding between two kernel paths.  Returns (tokens equal,
    the parts)."""
    same, ties = 0, []
    for rid, w in want.items():
        g = got[rid]
        i = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if i is None:
            same += len(w)
            continue
        same += i
        gap, top = tie_gap(torch, cfg, params, prompts[rid] + w[:i], w[i],
                           g[i])
        one_rank = same_path is not None and same_path[rid] == g
        ties.append(dict(request=rid, position=i, single=w[i], pp=g[i],
                         gap=gap, single_argmax=top,
                         equal_to_one_rank_same_path=one_rank))
        print(f"[{label}] request {rid} parts from the single-rank run at "
              f"token {i}: single {w[i]}, pp {g[i]}, single-rank logit gap "
              f"{gap:.4g} (bound {bound:.4g}); one rank through the "
              f"stages' kernels gives the pp tokens bit for bit: "
              f"{one_rank if same_path is not None else 'not run'}",
              flush=True)
        if not (abs(gap) < bound or one_rank):
            fail(f"[{label}]: request {rid} token {i} differs with a logit "
                 f"gap {gap} >= {bound}: not a near-tie, and not one "
                 f"rank's own path")
    return same, ties


def pp_one_stage(torch, cfg, params, prompts, kv):
    """A ``PPFifoScheduler`` of one stage (no process group) on one wave of
    ``prompts``, greedy, EOS off: the kernels a stage runs for a ragged
    wave's per-tick forward, on all rows at once.  Tokens by request."""
    from qwen_inference_engine_tpu_torch.engine.pp_scheduler import (
        PPFifoScheduler,
    )
    from qwen_inference_engine_tpu_torch.engine.types import Request
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.parallel.mesh import make_pp_mesh

    pp = PPFifoScheduler(cfg, params, mesh=make_pp_mesh(1),
                         max_batch=PP_WAVE, max_seq=PP_SEQ,
                         kv_dtype=getattr(torch, kv),
                         sampling=SamplingParams(greedy=True), seed=26,
                         device="cuda")
    pp._eos = set()
    for i, p in enumerate(prompts):
        pp.submit(Request(request_id=i, prompt=p,
                          max_new_tokens=PP_SERVE_NEW))
    out = {f.request_id: f.token_ids for f in pp.run_to_completion(8)}
    del pp
    torch.cuda.empty_cache()
    return out


def pp_single_serve(torch, cfg, params, prompts, kv, sampling):
    """The single-rank ``ContinuousBatchingEngine`` on ``prompts`` (8 slots,
    pages of 512, EOS off, greedy or ``sampling``): tokens by request."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, max_slots=PP_WAVE, page_size=PAGE, num_pages=12,
        max_pages_per_seq=PP_SEQ // PAGE, prefill_chunk=256,
        prefix_cache=False, kv_dtype=getattr(torch, kv),
        sampling=sampling or SamplingParams(greedy=True), device="cuda")
    cb._eos = set()
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p,
                          max_new_tokens=PP_SERVE_NEW))
    done = cb.run_to_completion(sync_every=8)
    out = {f.request_id: f.token_ids for f in done}
    del cb
    torch.cuda.empty_cache()
    return out


def run_pp_phases(torch, np, wrappers, layers=PP_LAYERS):
    """[pp forward], [pp 1f1b] and [pp serve] at pp = 2 and 4 in gloo
    worlds of ranks sharing the card, each against the single-rank port on
    the same seeded params.  The ranks time-share the card and exchange
    through the host: nothing here measures pipeline speed.  Returns
    (every rank's kernel launches summed, the row0 kernels' zero-copy
    launches by stage count, the numbers)."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    rng = np.random.default_rng(26)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = tp_model(torch, layers)
    L, V = cfg.num_layers, cfg.vocab_size
    # [pp forward]: the single-rank prefill and per-tick decode steps on
    # the same padded prompts, the reference's argmax fed to both
    T = max(PP_FORWARD_LENS)
    fwd_prompts = rng.integers(0, V, size=(4, T))
    fwd_lens = np.asarray(PP_FORWARD_LENS)
    dev = params["embed"].device

    def single_forward(c):
        cache = KVCache.create(L, 4, PP_SEQ, cfg.num_kv_heads, cfg.head_dim,
                               device=dev)
        with torch.inference_mode():
            logits, cache = qwen.prefill(params, c, torch.tensor(
                fwd_prompts, device=dev), torch.tensor(fwd_lens, device=dev),
                cache)
            outs, toks = [logits.float().cpu()], []
            for s in range(PP_FORWARD_STEPS):
                tok = torch.argmax(logits, dim=-1)
                toks.append(tok.cpu().numpy())
                logits, cache = qwen.decode_step(
                    params, c, tok, torch.tensor(fwd_lens + s, device=dev),
                    cache)
                outs.append(logits.float().cpu())
        return outs, np.stack(toks)

    ref_fwd, fwd_toks = single_forward(cfg)
    ref16, _ = single_forward(cfg.replace(act_bits=0))
    a8_vs_a16 = (ref_fwd[0] - ref16[0]).abs().max().item()
    bound = 2 * a8_vs_a16
    del ref16
    # [pp 1f1b]: the single-rank Engine.generate on the aligned wave
    f1b_prompts = rng.integers(0, V, size=(PP_WAVE, PP_PROMPT))
    ref_1f1b = {}
    for kv in ("bfloat16", "int8"):
        eng = Engine(cfg, params, max_batch=PP_WAVE, max_seq=PP_1F1B_SEQ,
                     kv_dtype=getattr(torch, kv),
                     sampling=SamplingParams(greedy=True), device="cuda")
        ref_1f1b[kv] = eng.generate(f1b_prompts.tolist(),
                                    max_new_tokens=PP_STEPS + 1).token_ids
        del eng
    # [pp serve]: the single-rank slot scheduler at the serve depth
    SL = PP_SERVE_LAYERS
    cfg_s = cfg.replace(num_layers=SL)
    params_s = dict(params, layers=qwen.map_params(params["layers"],
                                                   lambda t: t[:SL]))
    aligned = rng.integers(0, V, size=(PP_WAVE, PP_PROMPT)).tolist()
    ragged = [rng.integers(0, V, size=n).tolist() for n in PP_SERVE_RAGGED]
    serve_in = {"aligned": aligned, "ragged": ragged, "layers": SL}
    ref_serve = {}
    for kv in ("bfloat16", "int8"):
        ref_serve[kv, "greedy"] = pp_single_serve(torch, cfg_s, params_s,
                                                  aligned, kv, None)
        ref_serve[kv, "penalized"] = pp_single_serve(
            torch, cfg_s, params_s, aligned, kv, SamplingParams(**PP_PEN))
        ref_serve[kv, "ragged"] = pp_single_serve(torch, cfg_s, params_s,
                                                  ragged, kv, None)
        ref_serve[kv, "ragged one stage"] = pp_one_stage(
            torch, cfg_s, params_s, ragged, kv)
    serve_bound = 2 * tp_prefill_gap(torch, qwen, cfg_s, params_s, aligned)
    gc.collect()
    torch.cuda.empty_cache()

    launches = {n: 0 for n in wrappers}
    row0_launches = {}
    numbers = {"bound": bound, "a8_vs_a16": a8_vs_a16,
               "serve_bound": serve_bound, "serve_layers": SL}
    # both worlds at once: their ranks time-share the card
    done = spawn_worlds([(pp_rank, world, (
        layers, (fwd_prompts, fwd_lens, fwd_toks), f1b_prompts.tolist(),
        serve_in)) for world in PP_STAGES])
    for world in PP_STAGES:
        per, wall = done[world]
        print(f"[pp] a gloo world of {world} ranks on the card: {wall:.1f} s "
              f"(spawn, params, runs; beside the other world)", flush=True)
        numbers[f"pp{world}"] = res = {"wall_s": wall}
        # [pp forward]: bit for bit against one rank
        equal = [all(bool(torch.equal(g, w)) for g, w in zip(
            p["forward"]["logits"], ref_fwd)) for p in per]
        err = max((g - w).abs().max().item() for p in per
                  for g, w in zip(p["forward"]["logits"], ref_fwd))
        for r, p in enumerate(per):
            cnt = {n: c for n, c in p["forward"]["launches"].items() if c}
            print(f"[pp forward] pp={world} rank {r} launches {cnt}",
                  flush=True)
            for n in wrappers:
                launches[n] += p["forward"]["launches"][n]
            want = {"flash_attention": L // world,
                    "kv_append_ragged_t": L // world * PP_FORWARD_STEPS,
                    "decode_attention_contiguous":
                        L // world * PP_FORWARD_STEPS,
                    "ring_exchange": world * (1 + PP_FORWARD_STEPS),
                    "broadcast": 1 + PP_FORWARD_STEPS}
            wrong = {n: cnt.get(n, 0) for n, c in want.items()
                     if cnt.get(n, 0) != c}
            if wrong:
                fail(f"[pp forward] pp={world} rank {r}: launches {wrong}, "
                     f"want {want}")
        print(f"[pp forward] pp={world}, 7B W4A8 gs 64, {L} layers "
              f"({L // world} a stage), prefill of {PP_FORWARD_LENS} then "
              f"{PP_FORWARD_STEPS} per-tick decode steps: last-token logits "
              f"bit-equal to the single-rank prefill / decode_step on every "
              f"rank {equal} (max |d| {err:.4g}) | wall "
              f"{per[0]['forward']['wall_s']:.2f} s (ranks share the card)",
              flush=True)
        if not all(equal):
            fail(f"[pp forward] pp={world}: logits not bit-equal to one "
                 f"rank's (max |d| {err})")
        res["forward"] = dict(bit_equal=True, max_abs_diff=err)
        # [pp 1f1b]
        ticks = world + PP_STEPS * world
        for kv in ("bfloat16", "int8"):
            runs = [p[f"1f1b {kv}"] for p in per]
            toks = [x["tokens"] for x in runs]
            if any(t != toks[0] for t in toks):
                fail(f"[pp 1f1b {kv}] pp={world}: the ranks' tokens differ")
            kern = (["decode_attention_appending"] if kv == "bfloat16" else
                    ["kv_append_uniform_q8", "decode_attention_contiguous_q8"])
            for r, x in enumerate(runs):
                want = L // world * (ticks - r)
                got = {n: x["launches"][n] for n in kern}
                if not (x["tokens_equal"] and x["caches_equal"]) or any(
                        c != want for c in got.values()):
                    fail(f"[pp 1f1b {kv}] pp={world} rank {r}: zero-copy = "
                         f"sliced tokens {x['tokens_equal']}, caches "
                         f"{x['caches_equal']}; row0 launches {got}, want "
                         f"{want} ({L // world} a tick, {ticks - r} ticks)")
                for n in wrappers:
                    launches[n] += x["launches"][n]
                for n in kern:
                    row0_launches.setdefault(n, {}).setdefault(
                        f"pp{world}", []).append(x["launches"][n])
            ref = dict(enumerate(ref_1f1b[kv]))
            got = dict(enumerate(toks[0]))
            same, ties = pp_tokens_check(
                torch, f"pp 1f1b {kv}", got, ref,
                dict(enumerate(f1b_prompts.tolist())), cfg, params, bound)
            n_tok = PP_WAVE * (PP_STEPS + 1)
            print(f"[pp 1f1b {kv}] pp={world}, {L} layers, {PP_WAVE} rows "
                  f"(microbatches of {PP_WAVE // world}) x {PP_STEPS} steps "
                  f"after a {PP_PROMPT}-token prefill, {ticks} ticks: "
                  f"zero-copy = sliced, tokens and caches bit for bit, on "
                  f"every rank | row0 kernels {kern} launched "
                  f"{L // world} a tick a rank "
                  f"({[x['launches'][kern[0]] for x in runs]}) "
                  f"| tokens equal on every rank, equal to the single-rank "
                  f"Engine.generate {same}/{n_tok} ({len(ties)} near-ties) | "
                  f"wall zero-copy {runs[0]['wall_zero_copy_s']:.2f} s, "
                  f"sliced {runs[0]['wall_sliced_s']:.2f} s (ranks share the "
                  f"card)", flush=True)
            res[f"1f1b {kv}"] = dict(tokens_equal_single=same, tokens=n_tok,
                                     near_ties=ties, ticks=ticks)
        # [pp serve]
        for kv in ("bfloat16", "int8"):
            for label, kind, sp in PP_WAVES:
                runs = [p[f"serve {kv} {label}"] for p in per]
                toks = [x["tokens"] for x in runs]
                if any(t != toks[0] for t in toks):
                    fail(f"[pp serve {kv} {label}] pp={world}: the ranks' "
                         f"tokens differ")
                reasons = runs[0]["reasons"]
                if len(reasons) != PP_WAVE or any(
                        why != "length" for why in reasons.values()) or any(
                        len(t) != PP_SERVE_NEW for t in toks[0].values()):
                    fail(f"[pp serve {kv} {label}] pp={world}: not every "
                         f"request finished by length: {reasons}")
                fns = runs[0]["fns"]
                path = ("pp_decode" if kind == "ragged" else "pp_1f1b")
                flags = {"greedy": (False, False), "sampled": (True, False),
                         "penalized": (True, True)}.get(label)
                if not any(k[0] == path and (flags is None
                                             or k[2:] == flags)
                           for k in fns):
                    fail(f"[pp serve {kv} {label}] pp={world}: the wave did "
                         f"not ride {path} {flags}: {fns}")
                prompts = serve_in[kind]
                if label == "sampled":
                    want = {i: t for i, t in ref_serve[kv, "greedy"].items()
                            if i % 2 == 0}
                else:
                    want = ref_serve[kv, label]
                same, ties = pp_tokens_check(
                    torch, f"pp serve {kv} {label}",
                    {i: toks[0][i] for i in want}, want,
                    dict(enumerate(prompts)), cfg_s, params_s, serve_bound,
                    ref_serve.get((kv, f"{label} one stage")))
                for r, x in enumerate(runs):
                    for n in wrappers:
                        launches[n] += x["launches"][n]
                    print(f"[pp serve {kv} {label}] pp={world} rank {r} "
                          f"launches "
                          f"{ {n: c for n, c in x['launches'].items() if c} }",
                          flush=True)
                n_tok = PP_SERVE_NEW * len(want)
                print(f"[pp serve {kv} {label}] pp={world}, {SL} layers "
                      f"({PP_SERVE_CUT}), {PP_WAVE} requests, "
                      f"{PP_SERVE_NEW} new, by length: tokens equal on every "
                      f"rank | {'greedy rows ' if label == 'sampled' else ''}"
                      f"equal to the single-rank scheduler {same}/{n_tok} "
                      f"({len(ties)} parted: near-ties, or one rank's own "
                      f"kernel path) | {path} | wall "
                      f"{runs[0]['wall_s']:.2f} s (ranks share the card)",
                      flush=True)
                res[f"serve {kv} {label}"] = dict(
                    tokens_equal_single=same, tokens=n_tok, near_ties=ties,
                    wall_s=runs[0]["wall_s"])
    del params, params_s
    gc.collect()
    torch.cuda.empty_cache()
    return launches, row0_launches, numbers


def tp_prefill_gap(torch, qwen, cfg, params, prompts):
    """The single-rank W4A8 vs W4A16 distance of a prefill's last-token
    logits over ``prompts`` (bf16 KV): the near-tie rule's yardstick."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache

    B, T = len(prompts), len(prompts[0])
    toks = torch.tensor(prompts, device="cuda")
    lens = torch.full((B,), T, device="cuda")
    out = []
    for c in (cfg, cfg.replace(act_bits=0)):
        cache = KVCache.create(c.num_layers, B, PP_SEQ, c.num_kv_heads,
                               c.head_dim, device="cuda")
        with torch.inference_mode():
            out.append(qwen.prefill(params, c, toks, lens, cache)[0].float())
    return (out[0] - out[1]).abs().max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.engine import step_graph
    from qwen_inference_engine_tpu_torch.engine.engine import Engine, _bucket
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        fuse_projections,
        quantize_linear,
        quantize_params,
    )
    from qwen_inference_engine_tpu_torch.utils.metrics import kernel_wrappers

    t_start = time.perf_counter()

    def mark(phase):
        free, total = torch.cuda.mem_get_info()
        print(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s "
              f"(this process holds {torch.cuda.memory_reserved() / 2**30:.2f}"
              f" GiB; the card has {free / 2**30:.1f} of "
              f"{total / 2**30:.1f} GiB free)", flush=True)

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "smem" in line:
                print("  " + line.strip())

    # ---- 3. kernels vs plain versions at the Qwen2.5-7B shapes
    cfg = PRESETS["qwen2.5-7b"]
    gs = 256
    print("[kernels] each against its plain version on the card", flush=True)
    # the split-K kernels also at M = 40, a serving verify of 8 rows x 5
    # tokens
    ms_split = (4, 40, 256, 2048)
    qmm_recs = check_matmul(torch, cfg, "quant_matmul4_a8", gs,
                                ms_list=ms_split)
    # the kernels must also take every projection of the 14B preset
    cfg14 = PRESETS["qwen2.5-14b"]
    qmm_14b = check_matmul(torch, cfg14, "quant_matmul4_a8", gs,
                               ms_list=(4,))
    new_recs = {
        "quant_matmul4": check_matmul(torch, cfg, "quant_matmul4", 128,
                                          ms_list=ms_split, lm_head=True),
        "quant_matmul4 gs 256": check_matmul(
            torch, cfg, "quant_matmul4", 256, ms_list=ms_split),
        "quant_matmul8": check_matmul(torch, cfg, "quant_matmul8", 128,
                                          ms_list=ms_split, lm_head=True),
        "quant_matmul8 per column": check_matmul(
            torch, cfg, "quant_matmul8", None),
        "quant_matmul8_a8": check_matmul(torch, cfg, "quant_matmul8_a8",
                                             None, ms_list=ms_split),
        "quant_matmul8_a8 gs 128": check_matmul(
            torch, cfg, "quant_matmul8_a8", 128, ms_list=ms_split),
    }
    new_14b = {
        "quant_matmul4": check_matmul(torch, cfg14, "quant_matmul4", 128,
                                          ms_list=(4,)),
        "quant_matmul8": check_matmul(torch, cfg14, "quant_matmul8", 128,
                                          ms_list=(4,)),
        "quant_matmul8_a8": check_matmul(torch, cfg14, "quant_matmul8_a8",
                                             None, ms_list=(4,)),
    }
    plans = {label: fused_plans(label, r) for label, r in (
        ("quant_matmul4_a8 gs 256", qmm_recs),
        ("quant_matmul4 gs 128", new_recs["quant_matmul4"]),
        ("quant_matmul8 gs 128", new_recs["quant_matmul8"]),
        ("quant_matmul8_a8 per column", new_recs["quant_matmul8_a8"]))}
    cfg_moe = PRESETS["qwen3-30b-a3b"]
    flash_recs = check_flash(torch, cfg, cfg_moe)
    dec_recs = check_decode(torch, cfg)
    chunk_recs = check_chunk(torch, cfg)
    for name, by_t in check_chunk_rows(torch, cfg).items():
        chunk_recs[name].update(by_t)
    append_recs = check_kv_append(torch, cfg)
    dec8_recs = check_decode_q8(torch, cfg)
    paged_recs = {**check_paged_decode(torch, cfg),
                  **check_paged_q8_and_verify(torch, cfg),
                  **check_paged_chunk(torch, cfg, cfg_moe),
                  **check_paged_chunk(torch, cfg, cfg_moe, quant=True),
                  **check_paged_appends(torch, cfg)}
    check_wide_window_append(torch, cfg)
    fused_mlp_recs = check_fused_mlp(torch, cfg)
    attn_mlp_recs = check_fused_attn_mlp(torch, cfg)
    append_recs["kv_append_uniform"] = check_kv_append_uniform(torch, cfg)
    append_recs["kv_append_ragged_t"] = check_kv_append_ragged_t(torch, cfg)
    # the pipeline's row windows: the four row0 variants at the 1F1B shapes
    row0_recs = check_row0_kernels(torch, cfg)
    # the TP paths' kernels at the shapes a rank's shards give them
    tp_shard_errs = check_tp_shards(torch, cfg)
    deferred_recs = check_deferred_kernels(torch, cfg)
    attn_mm_recs = check_fused_attn_matmul(torch, cfg)
    grouped_recs = check_grouped_matmul(torch, PRESETS["qwen3-30b-a3b"])
    # the grouped kernels at the shard shapes the EP layer gives them
    ep_grouped_recs = check_ep_grouped(torch, PRESETS["qwen3-30b-a3b"])
    torch.cuda.empty_cache()
    mark("3 kernels")

    # ---- 4. end to end: Qwen2.5-7B, full depth, W4A8 gs 256, bf16 KV
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(bf16, QuantConfig(bits=4, group_size=gs))
    # the weight formats of runs (a)-(d), quantized from the same bf16
    # params: W4A16 gs 128 (the CLI default) with an INT4 lm_head; W8A16 gs
    # 128; W8A8 one scale per column; the JAX bench's headline weights
    # (W4A8 gs 256 blocks, INT4 lm_head at act_bits_lm_head=0)
    p_w4a16 = quantize_params(bf16, QuantConfig(bits=4, group_size=128,
                                                quantize_lm_head=True))
    p_w8a16 = quantize_params(bf16, QuantConfig(bits=8, group_size=128))
    p_w8a8 = quantize_params(bf16, QuantConfig(bits=8, group_size=None))
    p_bench = dict(params, lm_head=quantize_linear(bf16["lm_head"], 4, gs))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg8 = cfg.replace(act_bits=8)
    print(f"[e2e] {cfg.name}: {cfg.num_layers} layers, params built and "
          f"quantized in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    eng = Engine(cfg8, params, max_batch=4, max_seq=1024,
                 kv_dtype=torch.bfloat16, sampling=SamplingParams(greedy=True),
                 device="cuda")
    rng = np.random.default_rng(0)

    def prompts(lengths):
        return [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]

    warm_up(eng, prompts)
    wrappers = kernel_wrappers()
    paged = {n for n in wrappers if n.startswith("paged_")}
    engines = {
        "bf16": eng,
        "bf16 long": Engine(cfg8, params, max_batch=4, max_seq=2304,
                            kv_dtype=torch.bfloat16,
                            sampling=SamplingParams(greedy=True),
                            device="cuda"),
        "int8 long": Engine(cfg8, params, max_batch=4, max_seq=2304,
                            kv_dtype=torch.int8,
                            sampling=SamplingParams(greedy=True),
                            device="cuda"),
    }
    # run, engine, prompt lengths, kernels that must run, kernels that must not
    bf16_dec = {"decode_attention_contiguous", "decode_attention_appending"}
    q8 = {"chunk_attention_contiguous_q8", "kv_append_uniform_q8",
          "decode_attention_contiguous_q8"}
    # the ragged runs write every decode step's K/V with kv_append_ragged_t
    # (once a layer a step); the aligned runs never
    rag = {"kv_append_ragged_t"}
    deferred = {"decode_attention_contiguous_fresh", "kv_append_all_uniform"}
    plan = [
        ("ragged", "bf16", [37, 120, 300, 500],
         {"flash_attention", "decode_attention_contiguous"} | rag,
         {"decode_attention_appending", "chunk_attention_contiguous"} | q8),
        ("aligned", "bf16", [256] * 4,
         {"flash_attention", "decode_attention_appending"},
         {"decode_attention_contiguous", "chunk_attention_contiguous"} | q8
         | rag),
        ("bf16 aligned long", "bf16 long", [1408] * 4,
         {"flash_attention", "chunk_attention_contiguous",
          "decode_attention_appending"},
         {"decode_attention_contiguous"} | q8 | rag),
        ("bf16 ragged long", "bf16 long", [700, 1100, 1408, 1900],
         {"flash_attention", "chunk_attention_contiguous",
          "decode_attention_contiguous"} | rag,
         {"decode_attention_appending"} | q8),
        ("int8 aligned long", "int8 long", [1408] * 4,
         {"flash_attention"} | q8,
         {"chunk_attention_contiguous"} | bf16_dec | rag),
        ("int8 ragged long", "int8 long", [37, 600, 1408, 1900],
         {"flash_attention", "chunk_attention_contiguous_q8",
          "decode_attention_contiguous_q8"} | rag,
         {"chunk_attention_contiguous", "kv_append_uniform_q8"} | bf16_dec),
    ]
    for which in ("bf16 long", "int8 long"):
        warm_up(engines[which], prompts)
    launches = {n: 0 for n in wrappers}
    runs = {}
    for label, which, lengths, must, must_not in plan:
        for w in wrappers.values():
            w.launches = 0
        res = engines[which].generate(prompts(lengths), max_new_tokens=32)
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, c in counts.items():
            launches[n] += c
        ids = [t for row in res.token_ids for t in row]
        print(f"[e2e] {label} {lengths}: ttft {res.ttft_s * 1e3:.1f} ms | "
              f"decode {res.decode_tokens_per_s:.1f} tok/s | steps "
              f"{res.steps} | launches {counts}", flush=True)
        print(f"      first ids {[row[:8] for row in res.token_ids]}")
        if not all(0 <= t < cfg.vocab_size for t in ids) or len(set(ids)) < 2:
            fail(f"{label}: ids out of range or all identical")
        missing = sorted(n for n in must | {"quant_matmul4_a8"}
                         if counts[n] <= 0)
        stray = sorted(n for n in must_not | paged
                       | (set(MATMULS) - {"quant_matmul4_a8"})
                       | deferred if counts[n] != 0)
        if missing or stray:
            fail(f"{label}: kernels of its path not launched {missing}, "
                 f"kernels of other paths launched {stray}")
        want_rag = cfg.num_layers * (res.steps - 1) if rag <= must else 0
        if counts["kv_append_ragged_t"] != want_rag:
            fail(f"{label}: {counts['kv_append_ragged_t']} kv_append_ragged_t "
                 f"launches, expected {want_rag} (one a layer a decode step)")
        # one continuation per layer for each 512-token chunk after the
        # first of the prompt bucket
        want_chunks = cfg.num_layers * max(_bucket(max(lengths)) // 512 - 1, 0)
        got_chunks = counts["chunk_attention_contiguous"] + \
            counts["chunk_attention_contiguous_q8"]
        if got_chunks != want_chunks:
            fail(f"{label}: {got_chunks} continuation-chunk launches, "
                 f"expected {want_chunks}")
        runs[label] = dict(lengths=lengths, ttft_ms=res.ttft_s * 1e3,
                           decode_tok_s=res.decode_tokens_per_s,
                           steps=res.steps, launches=counts)
    del engines, eng
    torch.cuda.empty_cache()
    mark("4 e2e")

    # ---- 4 (a)-(d): the other weight formats through Engine.generate
    L = cfg.num_layers
    q8 = torch.int8
    variants = {
        # the prefill (M = 4 x 512) runs the three MLP matmuls, each decode
        # step (M = 4) fused_mlp: gs 128 leaves the down projection unpadded
        "(a) w4a16 gs 128, int4 lm_head, bf16 KV": (
            cfg, p_w4a16, torch.bfloat16, [37, 120, 300, 500],
            {"quant_matmul4": (7 * L + 1, 4 * L + 1), "fused_mlp": (0, L),
             "kv_append_ragged_t": (0, L)},
            {"flash_attention", "decode_attention_contiguous", "fused_mlp"}),
        "(b) w8a16 gs 128, bf16 lm_head, bf16 KV": (
            cfg, p_w8a16, torch.bfloat16, [256] * 4,
            {"quant_matmul8": 7 * L},
            {"flash_attention", "decode_attention_appending"}),
        "(c) w8a8 per column, int8 KV": (
            cfg8, p_w8a8, q8, [37, 120, 300, 500],
            {"quant_matmul8_a8": 7 * L, "kv_append_ragged_t": (0, L)},
            {"flash_attention", "decode_attention_contiguous_q8"}),
        "(d) w4a8 gs 256 + int4 lm_head (bench headline), bf16 KV": (
            cfg8, p_bench, torch.bfloat16, [37, 120, 300, 500],
            {"quant_matmul4_a8": 7 * L, "quant_matmul4": 1,
             "kv_append_ragged_t": (0, L)},
            {"flash_attention", "decode_attention_contiguous"}),
    }
    format_runs = run_formats(torch, cfg, variants, wrappers, prompts)
    for r in format_runs.values():
        for n, c in r["launches"].items():
            launches[n] += c
    runs.update(format_runs)
    del variants
    torch.cuda.empty_cache()

    # ---- 4 [graph generate]: captured decode steps against eager ones
    ragged = [37, 120, 300, 500]
    p_two = dict(params, layers=qwen.map_params(params["layers"],
                                                lambda t: t[:2]))
    graph_counts, graph_runs = run_graph_generate(torch, cfg8, [
        ("7B W4A8 ragged, bf16 KV", params, dict(max_batch=4, max_seq=1024),
         prompts(ragged), None),
        ("7B W4A8 ragged, INT8 KV", params,
         dict(max_batch=4, max_seq=1024, kv_dtype=torch.int8),
         prompts(ragged), None),
        ("7B W4A8 aligned, bf16 KV", params, dict(max_batch=4, max_seq=1024),
         prompts([256] * 4), None),
        ("(a) W4A16 gs 128 + INT4 lm_head, fused_mlp, ragged", p_w4a16,
         dict(cfg=cfg, max_batch=4, max_seq=1024), prompts(ragged), None),
        ("7B W4A8 at 2 layers, sampled (temperature 0.8, top-k 50, top-p "
         "0.9, repetition penalty 1.1)", p_two,
         dict(cfg=cfg8.replace(num_layers=2), max_batch=4, max_seq=1024),
         prompts(ragged), SamplingParams(**SAMPLED))], wrappers)
    del p_two
    for n, c in graph_counts.items():
        launches[n] += c
    fused = graph_runs["(a) W4A16 gs 128 + INT4 lm_head, fused_mlp, ragged"]
    if fused["launches_per_step"].get("fused_mlp") != L:
        fail(f"[graph generate] (a): a step launched "
             f"{fused['launches_per_step']}, want fused_mlp {L} times")
    runs["graph generate"] = graph_runs
    mark("4 formats and [graph generate]")

    # ---- 4 [fused generate], [fused serve], [ppl]: offline-fused
    # projections through Engine.generate and the serving engine, and the
    # perplexity of each weight format (own prompts: main's rng untouched)
    frng = np.random.default_rng(23)

    def fprompts(lengths):
        return [frng.integers(0, cfg.vocab_size, size=n).tolist()
                for n in lengths]

    f_w4a8 = fuse_projections(params)
    f_w4a16 = fuse_projections(p_w4a16)
    counts, runs["fused generate"] = run_fused_generate(torch, [
        ("7B W4A8 gs 256", cfg8, params, f_w4a8, "quant_matmul4_a8", 0,
         "7B W4A8 ragged, bf16 KV"),
        ("(a) W4A16 gs 128 + INT4 lm_head", cfg, p_w4a16, f_w4a16,
         "quant_matmul4", 1,
         "(a) W4A16 gs 128 + INT4 lm_head, fused_mlp, ragged")],
        wrappers, fprompts, graph_runs)
    for n, c in counts.items():
        launches[n] += c
    del f_w4a16
    torch.cuda.empty_cache()
    counts, runs["fused serve"] = run_fused_serve(torch, cfg8, params, f_w4a8,
                                                  wrappers, frng)
    for n, c in counts.items():
        launches[n] += c
    # W4A16 arm: the (a) blocks with the bf16 lm_head
    p_w4a16_bf16_head = dict(p_w4a16, lm_head=bf16["lm_head"])
    counts, runs["ppl"] = run_ppl(torch, np, [
        ("bf16", cfg, bf16, PPL_BATCH, None, 0),
        ("W8A16 gs 128", cfg, p_w8a16, PPL_BATCH, "quant_matmul8", 7 * L),
        ("W4A16 gs 128", cfg, p_w4a16_bf16_head, PPL_BATCH, "quant_matmul4",
         7 * L),
        ("W4A8 gs 256", cfg8, params, PPL_BATCH, "quant_matmul4_a8", 7 * L),
        ("W4A8 gs 256 fused", cfg8, f_w4a8, PPL_BATCH, "quant_matmul4_a8",
         4 * L),
        ("W4A8 gs 256, batch_size 1", cfg8, params, 1, "quant_matmul4_a8",
         7 * L)], wrappers)
    for n, c in counts.items():
        launches[n] += c
    del f_w4a8, p_w8a16, p_w4a16_bf16_head
    torch.cuda.empty_cache()
    mark("4 [fused generate], [fused serve], [ppl]")

    # ---- 4b. serving: ContinuousBatchingEngine at full depth, then HTTP
    serve_counts, serve_stats = run_serving(torch, np, cfg8, params, wrappers,
                                            rng)
    for n, c in serve_counts.items():
        launches[n] += c
    run_http(torch, cfg8, params)
    torch.cuda.empty_cache()
    mark("4b serving, http")
    # ---- 4c. the INT8 page pool and speculative decoding
    q8_counts, q8_serve = run_serving(torch, np, cfg8, params, wrappers, rng,
                                      kv_dtype=torch.int8)
    spec_runs = {"int8 pool": q8_serve}
    for n, c in q8_counts.items():
        launches[n] += c
    # ---- 4c [graph serve]: captured ticks against eager ones, both pools,
    # at 4 pages a sequence; the bf16 pool's captured tick again at 64
    graph_serve = {}
    for kv, pages in ((torch.bfloat16, 4), (torch.int8, 4),
                      (torch.bfloat16, SERVE_MAX_PAGES)):
        counts, graph_serve[f"{kv} {pages} pages"] = graph_serve_case(
            torch, cfg8, params, wrappers, rng, kv, pages, eager=pages == 4)
        for n, c in counts.items():
            launches[n] += c
    runs["graph serve"] = graph_serve
    mark("4c serve int8, [graph serve]")
    # the same echo traffic by plain chained decode first: the yardstick
    for kv, mode, draft, spec in (
            (torch.bfloat16, "step_batch", False, False),
            (torch.bfloat16, "step", False, True),
            (torch.bfloat16, "step_batch", False, True),
            (torch.int8, "step", False, True),
            (torch.int8, "step_batch", False, True),
            (torch.bfloat16, "step_batch", True, True)):
        counts, numbers = run_serving_spec(torch, cfg8, params, wrappers, rng,
                                           kv, mode, draft=draft,
                                           speculative=spec)
        kind = "draft" if draft else "pld" if spec else "plain"
        spec_runs[f"{kind} {kv} {mode}"] = numbers
        for n, c in counts.items():
            launches[n] += c
    counts, spec_runs["generate spec"] = run_generate_spec(
        torch, cfg8, params, wrappers, rng)
    for n, c in counts.items():
        launches[n] += c
    run_http_spec_int8(torch, cfg8, params)
    torch.cuda.empty_cache()
    mark("4c speculation")
    w4_counts, w4_serve = run_serving_w4a16(torch, cfg, p_w4a16, wrappers, rng)
    for n, c in w4_counts.items():
        launches[n] += c

    # ---- 4d. the double-pumped decode: the JAX bench's pumped weights
    # (W4A16 gs 256 pad-free: down gs 128; INT4 lm_head), batch 192
    p_pump = quantize_params(bf16, QuantConfig(bits=4, group_size=256,
                                               pad_free=True,
                                               quantize_lm_head=True))
    pump_counts, pump_run = run_pumped_generate(torch, cfg, p_pump, wrappers,
                                                prompts)
    for n, c in pump_counts.items():
        launches[n] += c
    counts, pumped_graph = run_graph_generate(torch, cfg, [
        ("pumped W4A16 gs 256 pad-free + INT4 lm_head, aligned", p_pump,
         dict(max_batch=PUMP_BATCH, max_seq=PUMP_SEQ, pumped=True),
         prompts([PUMP_PROMPT] * PUMP_BATCH), None)], wrappers)
    for n, c in counts.items():
        launches[n] += c
    per = next(iter(pumped_graph.values()))["launches_per_step"]
    if per.get("fused_attn_mlp") != 2 * L or \
            per.get("kv_append_uniform") != 2 * L:
        fail(f"[graph generate] pumped: a step launched {per}")
    runs["graph generate"].update(pumped_graph)
    mark("4d pumped")
    # [probe fused]: the overlap probe's fused attention + matmul
    probe_counts, probe_run = run_probe_fused(torch, cfg, wrappers)
    for n, c in probe_counts.items():
        launches[n] += c

    # ---- the loader phase: HF checkpoint -> quantize -> generate
    loader = run_loader_phase(torch, cfg, bf16)
    del bf16, p_bench
    torch.cuda.empty_cache()
    dense_grouped = {n: launches[n] for n in GROUPED if launches[n]}
    mark("4e probe, loader")
    if dense_grouped:
        fail(f"the dense runs launched grouped kernels: {dense_grouped}")

    # ---- 5. kernel path vs plain path, whole model at depth 4
    L4 = 4
    cfg4 = cfg8.replace(num_layers=L4)

    params4 = dict(params, layers=qwen.map_params(params["layers"],
                                                  lambda t: t[:L4]))
    p_lens = [37, 120, 300, 500]
    p_ids = prompts(p_lens)
    toks = torch.zeros((4, 512), dtype=torch.long, device="cuda")
    for i, p in enumerate(p_ids):
        toks[i, :len(p)] = torch.tensor(p, device="cuda")
    lens_t = torch.tensor(p_lens, device="cuda")

    def run_prefill(p, dtype, toks=toks, lens_t=lens_t, c4=cfg4):
        cache = KVCache.create(L4, 4, 1024, cfg.num_kv_heads, cfg.head_dim,
                               dtype=dtype, device="cuda")
        with torch.inference_mode():
            return qwen.prefill_chunked(p, c4, toks, lens_t, cache,
                                        chunk=512)[0]

    e4 = Engine(cfg4, params4, max_batch=4, max_seq=1024,
                sampling=SamplingParams(greedy=True), device="cuda")
    lk = run_prefill(params4, torch.bfloat16)
    tk = e4.generate(p_ids, max_new_tokens=8).token_ids
    # the swaps act on Python calls, so the swapped run's steps run eagerly
    with Swapped(plain_swaps()), step_graph.eager_steps():
        lp = run_prefill(params4, torch.bfloat16)
        tp = e4.generate(p_ids, max_new_tokens=8).token_ids
    params4_f32 = qwen.map_params(
        params4, lambda t: t.float() if t.is_floating_point() else t)
    with Swapped(f32_swaps()):
        lr = run_prefill(params4_f32, torch.float32)
    agree = sum(a == b for x, y in zip(tk, tp) for a, b in zip(x, y))
    total = sum(len(y) for y in tp)
    model_check("bf16 KV, one chunk", lk, lp, lr,
                f" | greedy tokens agree {agree}/{total}")

    def fused_check(label, p4, c4, lp_, lr_, split_logits, kern, head=0):
        """Offline-fused parameters (4 matmuls a layer) on phase 5's rule,
        against the split parameters' plain and fp32 runs."""
        before = kern.launches
        lf = run_prefill(fuse_projections(p4), torch.bfloat16, c4=c4)
        if kern.launches - before != 4 * L4 + head:
            fail(f"{label} fused: {kern.launches - before} matmul launches, "
                 f"want {4 * L4 + head}")
        model_check(f"{label}, fused projections (qkv, gateup)", lf, lp_,
                    lr_, f" | bit-equal to the split kernel path: "
                    f"{bool(torch.equal(lf, split_logits))}")

    fused_check("W4A8, bf16 KV, one chunk", params4, cfg4, lp, lr, lk,
                qm.quant_matmul4_a8)

    # the new weight formats, bf16 KV, one chunk
    for label, pq, pcfg, kern in (
            ("W4A16 gs 128 + int4 lm_head", p_w4a16, cfg, qm.quant_matmul4),
            ("W8A8 per column", p_w8a8, cfg8, qm.quant_matmul8_a8)):
        c4 = pcfg.replace(num_layers=L4)
        pq4 = dict(pq, layers=qwen.map_params(pq["layers"], lambda t: t[:L4]))
        before = kern.launches
        lkf = run_prefill(pq4, torch.bfloat16, c4=c4)
        head = int(hasattr(pq4.get("lm_head"), "q"))  # a quantized lm_head
        if kern.launches - before != 7 * L4 + head:
            fail(f"{label}: the model check did not run its kernel")
        with Swapped(plain_swaps()):
            lpf = run_prefill(pq4, torch.bfloat16, c4=c4)
        with Swapped(f32_swaps()):
            lrf = run_prefill(qwen.map_params(
                pq4, lambda t: t.float() if t.is_floating_point() else t),
                torch.float32, c4=c4)
        model_check(f"{label}, bf16 KV, one chunk", lkf, lpf, lrf)
        fused_check(f"{label}, bf16 KV, one chunk", pq4, c4, lpf, lrf, lkf,
                    kern, head)
    # the loop's names still hold the last format's 28-layer stacks
    del p_w4a16, p_w8a8, pq, pq4
    torch.cuda.empty_cache()

    # INT8 KV over two chunks: a fresh prefill, then a continuation
    q_lens = [600, 700, 900, 1000]
    toks8 = torch.zeros((4, 1024), dtype=torch.long, device="cuda")
    for i, p in enumerate(prompts(q_lens)):
        toks8[i, :len(p)] = torch.tensor(p, device="cuda")
    lens8 = torch.tensor(q_lens, device="cuda")
    before = ca.chunk_attention_contiguous_q8.launches
    lk8 = run_prefill(params4, torch.int8, toks8, lens8)
    if ca.chunk_attention_contiguous_q8.launches - before != L4:
        fail("the INT8-KV model check did not run its continuation chunk "
             "through chunk_attention_contiguous_q8")
    with Swapped(plain_swaps()):
        lp8 = run_prefill(params4, torch.int8, toks8, lens8)
    with Swapped(f32_swaps()):
        lr8 = run_prefill(params4_f32, torch.int8, toks8, lens8)
    model_check(f"INT8 KV, prompts {q_lens}, two chunks", lk8, lp8, lr8)
    for kv in (torch.bfloat16, torch.int8):
        paged_model_check(torch, cfg4, params4, params4_f32, prompts,
                          plain_swaps(), f32_swaps(), kv)

    # score_logits (the perplexity harness's forward): all [4, 512, V]
    # scores of a fresh prefill
    def run_score(p, dtype):
        cache = KVCache.create(L4, 4, 512, cfg.num_kv_heads, cfg.head_dim,
                               dtype=dtype, device="cuda")
        with torch.inference_mode():
            return qwen.score_logits(p, cfg4, toks, cache)

    before = wrappers["flash_attention"].launches
    sk = run_score(params4, torch.bfloat16)
    if wrappers["flash_attention"].launches - before != L4:
        fail("score_logits did not run flash_attention once a layer")
    with Swapped(plain_swaps()):
        sp_ = run_score(params4, torch.bfloat16)
    with Swapped(f32_swaps()):
        sr = run_score(params4_f32, torch.float32)
    model_check("W4A8, score_logits", sk, sp_, sr, what="[4, 512, V] scores")
    del sk, sp_, sr, params4_f32
    torch.cuda.empty_cache()
    pumped_model_check(torch, cfg.replace(num_layers=L4), dict(
        p_pump, layers=qwen.map_params(p_pump["layers"], lambda t: t[:L4])),
        prompts)
    del p_pump

    del params, params4, e4
    torch.cuda.empty_cache()
    mark("5 model checks")

    # ---- 6. Qwen3-30B-A3B at full width: generate, serve, logits, loader
    moe_counts, moe_runs = run_moe_phases(torch, np, rng, wrappers)
    for n, c in moe_counts.items():
        launches[n] += c
    mark("6 moe")

    # ---- 7. tensor and data parallelism
    tp_counts, runs["tensor parallel"] = run_tp_phases(torch, np, wrappers)
    for n, c in tp_counts.items():
        launches[n] += c
    mark("7 tp / dp")

    # ---- 8. expert parallelism
    ep_counts, runs["expert parallel"] = run_ep_phases(torch, np, wrappers)
    for n, c in ep_counts.items():
        launches[n] += c
    mark("8 ep")

    # ---- 9. pipeline parallelism
    pp_counts, row0_launches, runs["pipeline parallel"] = run_pp_phases(
        torch, np, wrappers)
    for n, c in pp_counts.items():
        launches[n] += c
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    mark("9 pp")

    # ---- results
    sources = {
        "quant_matmul4_a8": ("csrc/quant_matmul.cu",
                             "qwen_inference_engine_tpu/ops/quant_matmul.py:219"),
        "quant_matmul4": ("csrc/quant_matmul.cu",
                          "qwen_inference_engine_tpu/ops/quant_matmul.py:88"),
        "quant_matmul8": ("csrc/quant_matmul.cu",
                          "qwen_inference_engine_tpu/ops/quant_matmul.py:383"),
        "quant_matmul8_a8": ("csrc/quant_matmul.cu",
                             "qwen_inference_engine_tpu/ops/quant_matmul.py:297"),
        "flash_attention": ("csrc/flash_attention.cu",
                            "qwen_inference_engine_tpu/ops/flash_attention.py:125"),
        "decode_attention_contiguous": (
            "csrc/decode_attention.cu",
            "qwen_inference_engine_tpu/ops/decode_attention.py:345"),
        "decode_attention_appending": (
            "csrc/decode_attention.cu",
            "qwen_inference_engine_tpu/ops/decode_attention.py:692"),
        "chunk_attention_contiguous": (
            "csrc/chunk_attention.cu",
            "qwen_inference_engine_tpu/ops/chunk_attention.py:116"),
        "chunk_attention_contiguous_q8": (
            "csrc/chunk_attention.cu",
            "qwen_inference_engine_tpu/ops/chunk_attention.py:225"),
        "kv_append_uniform_q8": (
            "csrc/kv_append.cu",
            "qwen_inference_engine_tpu/ops/kv_append.py:198"),
        "decode_attention_contiguous_q8": (
            "csrc/decode_attention.cu",
            "qwen_inference_engine_tpu/ops/decode_attention.py:319"),
        "paged_decode_attention_stacked": (
            "csrc/paged_attention.cu",
            "qwen_inference_engine_tpu/ops/paged_attention.py:167"),
        "paged_chunk_attention": (
            "csrc/chunk_attention.cu",
            "qwen_inference_engine_tpu/ops/chunk_attention.py:477"),
        "paged_append_ragged": (
            "csrc/kv_append.cu", "qwen_inference_engine_tpu/ops/kv_append.py:488"),
        "paged_append_prefill": (
            "csrc/kv_append.cu", "qwen_inference_engine_tpu/ops/kv_append.py:718"),
        "paged_decode_attention_stacked_q8": (
            "csrc/paged_attention.cu",
            "qwen_inference_engine_tpu/ops/paged_attention.py:358"),
        "paged_verify_attention_stacked": (
            "csrc/paged_attention.cu",
            "qwen_inference_engine_tpu/ops/paged_attention.py:167"),
        "paged_verify_attention_stacked_q8": (
            "csrc/paged_attention.cu",
            "qwen_inference_engine_tpu/ops/paged_attention.py:358"),
        "paged_chunk_attention_q8": (
            "csrc/chunk_attention.cu",
            "qwen_inference_engine_tpu/ops/chunk_attention.py:526"),
        "paged_append_ragged_t": (
            "csrc/kv_append.cu", "qwen_inference_engine_tpu/ops/kv_append.py:607"),
        "grouped_matmul4_a8": (
            "csrc/grouped_matmul.cu",
            "qwen_inference_engine_tpu/ops/grouped_matmul.py:323"),
        "grouped_matmul4": (
            "csrc/grouped_matmul.cu",
            "qwen_inference_engine_tpu/ops/grouped_matmul.py:193"),
        "grouped_matmul8": (
            "csrc/grouped_matmul.cu",
            "qwen_inference_engine_tpu/ops/grouped_matmul.py:426"),
        "fused_mlp": ("csrc/fused_step.cu",
                      "qwen_inference_engine_tpu/ops/fused_step.py:646"),
        "fused_attn_mlp": ("csrc/fused_step.cu",
                           "qwen_inference_engine_tpu/ops/fused_step.py:415"),
        "kv_append_uniform": ("csrc/kv_append.cu",
                              "qwen_inference_engine_tpu/ops/kv_append.py:95"),
        "kv_append_ragged_t": ("csrc/kv_append.cu",
                               "qwen_inference_engine_tpu/ops/kv_append.py:390"),
        "decode_attention_contiguous_fresh": (
            "csrc/decode_attention.cu",
            "qwen_inference_engine_tpu/ops/decode_attention.py:479"),
        "kv_append_all_uniform": ("csrc/kv_append.cu",
                                  "qwen_inference_engine_tpu/ops/kv_append.py:299"),
        "fused_attn_matmul": ("csrc/fused_step.cu",
                              "qwen_inference_engine_tpu/ops/fused_step.py:520"),
    }
    def split_record(recs, extra_err):
        """A split-K matmul's entry: the decode layer, plus the layer at
        M = 4 and 40 (with graph times), the fused parameters' layer at
        M = 4 (qkv, o, gateup, down) and the gate at M = 2048."""
        return dict(layer_record(recs, extra_err), at_M4=layer_at(recs, 4),
                    at_M40=layer_at(recs, 40),
                    at_M4_fused=layer_at(recs, 4, FUSED_PROJS),
                    at_gate_M2048=next(r for r in recs if r["M"] == 2048
                                       and r["proj"] == "gate"),
                    at_gateup_M2048=next(r for r in recs if r["M"] == 2048
                                         and r["proj"] == "gateup"))

    # each matmul is reported per decode layer: its seven projections at M=4
    recs = {"quant_matmul4_a8": split_record(qmm_recs, qmm_14b),
            "quant_matmul4": split_record(
                new_recs["quant_matmul4"],
                new_recs["quant_matmul4 gs 256"] + new_14b["quant_matmul4"]),
            "quant_matmul8": split_record(
                new_recs["quant_matmul8"],
                new_recs["quant_matmul8 per column"]
                + new_14b["quant_matmul8"]),
            "quant_matmul8_a8": split_record(
                new_recs["quant_matmul8_a8"],
                new_recs["quant_matmul8_a8 gs 128"]
                + new_14b["quant_matmul8_a8"]),
            "flash_attention": dict(
                flash_recs[0], at_serving_piece=flash_recs[1],
                at_30b_a3b=flash_recs[2]),
            **dec_recs, **chunk_recs,
            **append_recs, **dec8_recs, **paged_recs,
            **{n: moe_layer_record(r) for n, r in grouped_recs.items()},
            # the fused MLP at decode (M = 4) with the pumped weights, and
            # at the default dispatch's batch of 192 and serving's pieces
            # of 256; the fused attention + MLP at the pumped step's second
            # half
            "fused_mlp": dict(
                next(r for r in fused_mlp_recs
                     if r["M"] == 4 and r["gs"] == (256, 128)),
                **{f"at_M{m}": next(r for r in fused_mlp_recs
                                    if r["M"] == m and r["gs"] == (256, 128))
                   for m in (192, 256)}),
            "fused_attn_mlp": dict(
                attn_mlp_recs[(PUMP_BATCH // 2, PUMP_BATCH // 2)],
                at_Mb40=attn_mlp_recs[(PUMP_BATCH // 2, 40)]),
            # the deferred decode's kernels at its batch of 192; the fused
            # attention + matmul at the probe's row0 0
            **deferred_recs, "fused_attn_matmul": attn_mm_recs[0]}
    for name, err in tp_shard_errs.items():
        recs[name] = dict(recs[name], max_abs_err=max(
            recs[name]["max_abs_err"], err), tp_shards_max_abs_err=err)
    for name, ep_recs in ep_grouped_recs.items():
        err = max(r["max_abs_err"] for r in ep_recs)
        recs[name] = dict(recs[name], max_abs_err=max(
            recs[name]["max_abs_err"], err), at_ep_shards=ep_layer_record(
                ep_recs))
    # the row0 variants at the 1F1B shapes, with the zero-copy [pp 1f1b]
    # runs' launches of each rank (none for decode_attention_contiguous: a
    # bf16 uniform decode takes the appending kernel)
    for name, by_pp in row0_recs.items():
        err = max(r["max_abs_err"] for r in by_pp.values())
        recs[name] = dict(recs[name], max_abs_err=max(
            recs[name]["max_abs_err"], err), at_row0=dict(
                by_pp, launches_1f1b=row0_launches.get(name, {})))
    sites = {replaces for _, replaces in sources.values()}
    if set(recs) != set(wrappers) or set(sources) != set(wrappers) \
            or len(sites) != 28:
        fail(f"the kernels line must list every wrapper ({len(wrappers)}) "
             f"over the JAX package's 28 pallas_call sites: {len(recs)} "
             f"records, {len(sites)} sites")
    kernels = []
    for name, rec in recs.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "qwen_inference_engine_tpu_torch/" + src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec.get("shape", rec.get("unit")),
            **{k: v for k, v in rec.items()
               if k in ("gather_ms", "graph_ms", "library_graph_ms",
                        "kernel", "identity_bit_equal")
               or k.startswith(("int8_", "rows_", "start_", "at_", "tp_"))}})
    print(f"[done] {time.perf_counter() - t_start:.1f} s | serving "
          f"{json.dumps(serve_stats)} | serving w4a16 {json.dumps(w4_serve)}"
          f" | loader {json.dumps(loader)} | int8 pool and speculation "
          f"{json.dumps(spec_runs)} | moe {json.dumps(moe_runs)} | pumped "
          f"{json.dumps(pump_run)} | probe fused {json.dumps(probe_run)}")
    if len(sys.argv) > 1:  # every kernel shape's and run's numbers
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])),
                    exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump({"runs": runs, "new_matmuls": new_recs, "new_14b": new_14b,
                       "w4a8": qmm_recs, "serving": serve_stats,
                       "serving_w4a16": w4_serve, "loader": loader,
                       "int8_pool_and_speculation": spec_runs,
                       "paged_kernels": paged_recs,
                       "chunk_kernels": chunk_recs,
                       "grouped_kernels": grouped_recs, "moe": moe_runs,
                       "grouped_kernels_ep_shards": ep_grouped_recs,
                       "fused_mlp": fused_mlp_recs,
                       "fused_attn_mlp": {f"row0 {r} Mb {m}": rec for (
                           r, m), rec in attn_mlp_recs.items()},
                       "pumped_generate": pump_run,
                       "deferred_kernels": deferred_recs,
                       "fused_attn_matmul": attn_mm_recs,
                       "probe_fused": probe_run, "fused_plans": plans,
                       "row0_kernels": row0_recs},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
