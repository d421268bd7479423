"""Time serving decode ticks of the PyTorch port on the card, at the block
table widths of ``chip_smoke.py`` (4 pages of 512 a sequence) and of the
scheduler's default (64).

    python3 scripts/time_serving_torch.py ROOT [OUT.json]

ROOT is a checkout of the repository (this one, or an older commit's
``git archive``), so two commits compare on one card: run them as
parent / change / change / parent.  Qwen2.5-7B at full depth (28 layers)
from ``chip_smoke.py``'s seeded weights, W4A8 gs 256; for a bf16 and an
INT8 page pool and each width: 8 slots, pages of 512, pieces of 256,
prefix cache on, greedy, EOS off; 8 prompts (150..1400 tokens, 160 new
each) fill the slots, then 6 chained windows of 8 decode ticks are timed
by the host clock (synchronized around each window), and one more under
``torch.profiler`` for the device's busy time (its kernels, copies and
sets; not the ops' rows, which repeat their kernels' time).  Then, for each pool, one
1536-token prompt alone (prefix cache off, after a warm-up prompt of the
same length): its six 256-token pieces (a fresh one, then continuations at
starts 256..1280) and first token as one scheduler tick, by the host clock
and under ``torch.profiler``: host ms, device busy ms a piece, and the
paged chunk kernels' device ms and launches.  Prints one JSON object
(and writes it to OUT.json when given), with the card's name and power
limit.  Needs a CUDA device.
"""

import json
import os
import subprocess
import sys
import time

LENS = [150, 300, 450, 600, 750, 900, 1150, 1400]
TICKS, WINDOWS = 8, 6
PREFILL = 1536      # six pieces of 256


def device_events(prof):
    """The profile's device-side rows (kernels, copies, sets): a PyTorch
    op's own row repeats the device time of the kernels it launched."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_serving_torch: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["qwen2.5-7b"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(bf16, QuantConfig(bits=4, group_size=256))
    del bf16
    cfg = cfg.replace(act_bits=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in LENS]
    out = {"root": root, "card": card, "runs": {}}
    for kv in (torch.bfloat16, torch.int8):
        for width in (4, 64):
            cb = ContinuousBatchingEngine(
                cfg, params, max_slots=8, page_size=512, num_pages=40,
                max_pages_per_seq=width, prefill_chunk=256,
                prefix_cache=True, sampling=SamplingParams(greedy=True),
                kv_dtype=kv, device="cuda")
            cb._eos = set()
            for i, p in enumerate(prompts):
                cb.submit(Request(request_id=i, prompt=p,
                                  max_new_tokens=160))
            while cb.num_pending or any(s is None or not s.prefill_done
                                        for s in cb._slots):
                cb.step_batch(TICKS)
            cb.step_batch(TICKS)       # warm
            ms = []
            for _ in range(WINDOWS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cb.step_batch(TICKS)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / TICKS)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                cb.step_batch(TICKS)
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total
                       for e in device_events(prof)) / 1e3 / TICKS
            cb.run_to_completion()
            key = f"{'int8' if kv == torch.int8 else 'bf16'} width {width}"
            out["runs"][key] = dict(ms_per_tick=ms, device_busy_ms_per_tick=busy)
            print(f"{key}: ms per tick {[round(m, 3) for m in ms]}, device "
                  f"busy {busy:.3f} ms per tick", flush=True)
            del cb
            torch.cuda.empty_cache()
    for kv in (torch.bfloat16, torch.int8):
        cb = ContinuousBatchingEngine(
            cfg, params, max_slots=8, page_size=512, num_pages=40,
            max_pages_per_seq=4, prefill_chunk=256, prefix_cache=False,
            sampling=SamplingParams(greedy=True), kv_dtype=kv, device="cuda")
        rec = {}
        for rid in range(2):
            prompt = rng.integers(0, cfg.vocab_size, size=PREFILL).tolist()
            cb.submit(Request(request_id=rid, prompt=prompt,
                              max_new_tokens=1))
            torch.cuda.synchronize()
            if rid == 0:
                cb.step()
                continue
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                done = cb.step()
                torch.cuda.synchronize()
                rec["host_ms"] = (time.perf_counter() - t0) * 1e3
            assert [f.request_id for f in done] == [rid], done
            events = device_events(prof)
            pieces = PREFILL // 256
            rec["device_busy_ms_per_piece"] = sum(
                e.self_device_time_total for e in events) / 1e3 / pieces
            chunk = [e for e in events if "paged_chunk" in e.key]
            rec["paged_chunk_kernels"] = {
                e.key[:60]: dict(device_ms=e.self_device_time_total / 1e3,
                                 launches=e.count) for e in chunk}
            rec["paged_chunk_ms_per_piece"] = sum(
                e.self_device_time_total for e in chunk) / 1e3 / (pieces - 1)
        key = f"prefill {'int8' if kv == torch.int8 else 'bf16'}"
        out["runs"][key] = rec
        print(f"{key}: {json.dumps(rec)}", flush=True)
        del cb
        torch.cuda.empty_cache()
    print(json.dumps(out))
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
