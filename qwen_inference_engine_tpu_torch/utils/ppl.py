"""Perplexity of a token stream (the WikiText-2 protocol).

The port of the JAX package's ``utils/ppl.py``, which gates quantization
accuracy (its BASELINE: INT8 Δppl <= 0.1, INT4 Δppl <= 0.5 against FP16).
The stream is split into fixed windows of ``seq_len`` tokens; each window
scores positions 1..seq_len-1 with ``models/qwen.score_logits`` (one
fresh prefill: flash attention and the projection matmuls at M = B * T on
the card); ppl = exp(total NLL / total tokens).  A last batch short of
``batch_size`` windows is padded with copies of its last window, whose
rows are dropped.  The JAX ``jax.jit`` becomes an eager forward on the
parameters' device.

No dataset can be downloaded: pass a local text file
(``perplexity_of_file``), or a synthetic stream, which measures
quantization deltas (both arms see the same tokens).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.models.qwen import score_logits


@torch.inference_mode()
def nll_of_windows(params: dict, cfg: ModelConfig, token_windows: np.ndarray,
                   batch_size: int = 4) -> tuple[float, int]:
    """Sum of next-token negative log-likelihoods over ``token_windows``
    ``[num_windows, seq_len]``; returns (total_nll, total_predicted_tokens).
    The first token of a window has no context and is not scored."""
    num_windows, seq_len = token_windows.shape
    device, dtype = params["embed"].device, params["embed"].dtype
    # the fresh prefill writes K/V into the cache and attends over the fresh
    # K/V; the cache's contents are never read
    cache = KVCache.create(cfg.num_layers, batch_size, seq_len,
                           cfg.num_kv_heads, cfg.head_dim, dtype=dtype,
                           device=device)
    total_nll = 0.0
    total_tok = 0
    for i in range(0, num_windows, batch_size):
        chunk = token_windows[i:i + batch_size]
        real = chunk.shape[0]
        if real < batch_size:  # pad the batch, drop the padded rows after
            pad = np.repeat(chunk[-1:], batch_size - real, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        tokens = torch.as_tensor(chunk, dtype=torch.long, device=device)
        logits = score_logits(params, cfg, tokens, cache)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tok_lp = logp.gather(-1, tokens[:, 1:, None])[..., 0]
        nll = -tok_lp.sum(dim=-1)                         # [B]
        total_nll += float(nll[:real].sum())
        total_tok += real * (seq_len - 1)
    return total_nll, total_tok


def perplexity(params: dict, cfg: ModelConfig, token_ids: Sequence[int],
               seq_len: int = 512, batch_size: int = 4) -> float:
    """Windowed perplexity of a token stream."""
    ids = np.asarray(token_ids, np.int64)
    n_windows = len(ids) // seq_len
    if n_windows == 0:
        raise ValueError(f"need ≥{seq_len} tokens, got {len(ids)}")
    windows = ids[:n_windows * seq_len].reshape(n_windows, seq_len)
    nll, ntok = nll_of_windows(params, cfg, windows, batch_size)
    return math.exp(nll / ntok)


def perplexity_of_file(params: dict, cfg: ModelConfig, path: str, tokenizer,
                       seq_len: int = 512, batch_size: int = 4) -> float:
    """Perplexity of a UTF-8 text file under ``tokenizer``."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return perplexity(params, cfg, tokenizer.encode(text), seq_len,
                      batch_size)
