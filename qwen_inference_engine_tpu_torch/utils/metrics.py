"""Serving metrics: TTFT percentiles, decode throughput, token counters;
and the launch counts of the port's kernels.

The snapshot is what the HTTP server's ``/stats`` returns, with the JAX
package's keys.  ``spec_rounds`` counts row-rounds of speculation (a round
over B decoding rows counts B) and ``spec_tokens_per_forward`` is the mean
tokens a row emitted per verify forward (1..k+1).

``kernel_wrappers()`` names every kernel wrapper of the port; each counts
the launches of its kernel in its ``launches`` attribute (a CPU tensor's
plain version counts none), so a run that sets them to 0 before and reads
them after shows which kernels its path went through.  A wrapper counts
where Python calls it, so a CUDA graph's replay would count nothing and
its capture would count launches that never ran: ``launch_counts`` and
``add_launches`` let the captured steps (``engine/step_graph.py``) take
the capture's calls back out and add them again at each replay.
``collective_wrappers()`` names the TP, DP, EP and PP steps' collectives,
which count their calls the same way, and ``counted_wrappers()`` both
sets.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List


def kernel_wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper of the port, by name."""
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm

    wrappers = [
        qm.quant_matmul4_a8, qm.quant_matmul4, qm.quant_matmul8,
        qm.quant_matmul8_a8, fa.flash_attention,
        da.decode_attention_contiguous, da.decode_attention_appending,
        ca.chunk_attention_contiguous, ca.chunk_attention_contiguous_q8,
        ka.kv_append_uniform_q8, da.decode_attention_contiguous_q8,
        pa.paged_decode_attention_stacked, ca.paged_chunk_attention,
        ka.paged_append_ragged, ka.paged_append_prefill,
        pa.paged_decode_attention_stacked_q8,
        pa.paged_verify_attention_stacked,
        pa.paged_verify_attention_stacked_q8, ca.paged_chunk_attention_q8,
        ka.paged_append_ragged_t, gm.grouped_matmul4_a8, gm.grouped_matmul4,
        gm.grouped_matmul8, fs.fused_mlp, fs.fused_attn_mlp,
        ka.kv_append_uniform, ka.kv_append_ragged_t,
        da.decode_attention_contiguous_fresh, ka.kv_append_all_uniform,
        fs.fused_attn_matmul]
    return {w.__name__: w for w in wrappers}


def collective_wrappers() -> Dict[str, Callable]:
    """The collectives of the TP, DP, EP and PP steps
    (``parallel/mesh.py``), by name."""
    from qwen_inference_engine_tpu_torch.parallel import mesh

    return {w.__name__: w for w in (mesh.all_reduce, mesh.reduce_scatter,
                                    mesh.all_gather,
                                    mesh.all_to_all, mesh.ring_exchange,
                                    mesh.broadcast, mesh.gather_data,
                                    mesh.broadcast_data)}


def counted_wrappers() -> Dict[str, Callable]:
    """Every counted launch: the kernels' and the collectives'."""
    return {**kernel_wrappers(), **collective_wrappers()}


def launch_counts(wrappers: Dict[str, Callable]) -> Dict[str, int]:
    """Each wrapper's launch count, by name."""
    return {name: w.launches for name, w in wrappers.items()}


def add_launches(wrappers: Dict[str, Callable],
                 delta: Dict[str, int]) -> None:
    """Add ``delta[name]`` launches to each named wrapper's count (a
    negative delta takes them back out)."""
    for name, n in delta.items():
        wrappers[name].launches += n


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._ttfts: List[float] = []
        self._decode_tokens = 0
        self._decode_time = 0.0
        self._prefill_tokens = 0
        self._prefix_hit_tokens = 0
        self._requests = 0
        self._spec_rounds = 0
        self._spec_tokens = 0

    def observe_ttft(self, seconds: float) -> None:
        with self._lock:
            self._ttfts.append(seconds)
            self._requests += 1

    def observe_decode(self, tokens: int, seconds: float) -> None:
        with self._lock:
            self._decode_tokens += tokens
            self._decode_time += seconds

    def observe_prefill(self, tokens: int) -> None:
        with self._lock:
            self._prefill_tokens += tokens

    def observe_prefix_hit(self, tokens: int) -> None:
        """Prompt tokens served from the prefix cache (no forward run)."""
        with self._lock:
            self._prefix_hit_tokens += tokens

    def observe_spec(self, rounds: int, tokens: int) -> None:
        """``rounds`` row-rounds of speculation emitted ``tokens`` tokens."""
        with self._lock:
            self._spec_rounds += rounds
            self._spec_tokens += tokens

    @staticmethod
    def _pct(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
        return sorted_vals[idx]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            ttfts = sorted(self._ttfts)
            return {
                "requests": self._requests,
                "ttft_p50_s": self._pct(ttfts, 0.50),
                "ttft_p90_s": self._pct(ttfts, 0.90),
                "ttft_p99_s": self._pct(ttfts, 0.99),
                "decode_tokens": self._decode_tokens,
                "decode_tokens_per_s": (
                    self._decode_tokens / self._decode_time
                    if self._decode_time > 0 else 0.0
                ),
                "prefill_tokens": self._prefill_tokens,
                "prefix_hit_tokens": self._prefix_hit_tokens,
                "spec_rounds": self._spec_rounds,
                "spec_tokens_per_forward": (
                    self._spec_tokens / self._spec_rounds
                    if self._spec_rounds else 0.0
                ),
            }
