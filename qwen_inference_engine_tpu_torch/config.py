"""Model configuration for the Qwen2 / Qwen2.5 / Qwen3 families.

The port's own copy of the JAX package's ``config.py``: the same
``ModelConfig`` fields, ``PRESETS`` and ``tiny_config``, so a configuration
means the same model in both packages.  Per-model eps / rope_theta /
qk-norm / bias come from the config, never from the kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a Qwen-family causal LM."""

    name: str = "qwen"
    vocab_size: int = 151936
    hidden_size: int = 5120
    intermediate_size: int = 17408
    num_layers: int = 40
    num_heads: int = 40
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 32768
    # Qwen3 applies per-head RMSNorm to Q and K (reference qk_norm.cu:43-80).
    qk_norm: bool = False
    # Qwen2/2.5 use bias on q/k/v projections; Qwen3 does not.
    attention_bias: bool = True
    tie_word_embeddings: bool = False
    # <|im_end|> = 151645 is the reference's hardcoded stop id
    # (layers/src/qwen_main.cu:257); <|endoftext|> = 151643 also terminates.
    eos_token_ids: tuple = (151645, 151643)
    # Runtime quantization knob (not architecture): 8 quantizes activations
    # per token in the transformer-block projections and runs int8 x int8
    # products against the int4 weights (W4A8, ops/quant_matmul.py).
    # 0 = bf16 activations (weight-only quant).  The lm_head has its own
    # knob (logit fidelity is sampling-critical, so it gates separately).
    act_bits: int = 0
    act_bits_lm_head: int = 0
    # Qwen3-MoE (model_type qwen3_moe): num_experts == 0 means dense
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def gqa_groups(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # HF config.json interop
    # ------------------------------------------------------------------
    @staticmethod
    def from_hf_config(cfg: Mapping[str, Any], name: str = "") -> "ModelConfig":
        """Build from a HuggingFace config dict (``config.json`` contents)."""
        model_type = cfg.get("model_type", "qwen2")
        num_heads = cfg["num_attention_heads"]
        head_dim = cfg.get("head_dim") or cfg["hidden_size"] // num_heads
        is_qwen3 = model_type in ("qwen3", "qwen3_moe")
        eos = cfg.get("eos_token_id", 151645)
        if isinstance(eos, int):
            eos_ids: Sequence[int] = (eos,)
        else:
            eos_ids = tuple(eos)
        return ModelConfig(
            name=name or cfg.get("_name_or_path", model_type),
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=cfg.get("num_key_value_heads", num_heads),
            head_dim=head_dim,
            rope_theta=cfg.get("rope_theta", 1e6),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            max_position_embeddings=cfg.get("max_position_embeddings", 32768),
            qk_norm=is_qwen3,
            attention_bias=not is_qwen3,
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            eos_token_ids=tuple(eos_ids),
            num_experts=cfg.get("num_experts", 0) if model_type == "qwen3_moe" else 0,
            num_experts_per_tok=cfg.get("num_experts_per_tok", 0)
            if model_type == "qwen3_moe" else 0,
            moe_intermediate_size=cfg.get("moe_intermediate_size", 0)
            if model_type == "qwen3_moe" else 0,
            norm_topk_prob=cfg.get("norm_topk_prob", True),
        )

    @staticmethod
    def from_json(path: str, name: str = "") -> "ModelConfig":
        with open(path) as f:
            return ModelConfig.from_hf_config(json.load(f), name=name)

    @staticmethod
    def from_pretrained(path_or_name: str) -> "ModelConfig":
        """Load from a local HF checkpoint dir or a preset name."""
        key = path_or_name.lower().strip()
        if key in PRESETS:
            return PRESETS[key]
        cfg_path = os.path.join(path_or_name, "config.json")
        if os.path.exists(cfg_path):
            return ModelConfig.from_json(cfg_path, name=os.path.basename(path_or_name))
        raise ValueError(
            f"unknown model {path_or_name!r}: not a preset "
            f"({sorted(PRESETS)}) and no config.json found"
        )

    def to_hf_config(self) -> dict:
        """Inverse of from_hf_config — used by tests to build HF models."""
        if self.is_moe:
            return {
                "model_type": "qwen3_moe",
                "vocab_size": self.vocab_size,
                "hidden_size": self.hidden_size,
                "intermediate_size": self.intermediate_size,
                "moe_intermediate_size": self.moe_intermediate_size,
                "num_experts": self.num_experts,
                "num_experts_per_tok": self.num_experts_per_tok,
                "norm_topk_prob": self.norm_topk_prob,
                "decoder_sparse_step": 1,
                "mlp_only_layers": [],
                "num_hidden_layers": self.num_layers,
                "num_attention_heads": self.num_heads,
                "num_key_value_heads": self.num_kv_heads,
                "head_dim": self.head_dim,
                "rope_theta": self.rope_theta,
                "rms_norm_eps": self.rms_norm_eps,
                "max_position_embeddings": self.max_position_embeddings,
                "tie_word_embeddings": self.tie_word_embeddings,
                "eos_token_id": list(self.eos_token_ids),
            }
        return {
            "model_type": "qwen3" if self.qk_norm else "qwen2",
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "intermediate_size": self.intermediate_size,
            "num_hidden_layers": self.num_layers,
            "num_attention_heads": self.num_heads,
            "num_key_value_heads": self.num_kv_heads,
            "head_dim": self.head_dim,
            "rope_theta": self.rope_theta,
            "rms_norm_eps": self.rms_norm_eps,
            "max_position_embeddings": self.max_position_embeddings,
            "tie_word_embeddings": self.tie_word_embeddings,
            "eos_token_id": list(self.eos_token_ids),
        }


def _qwen2(name, V, D, F, L, H, HK, theta=1e6, tie=False, max_pos=32768) -> ModelConfig:
    return ModelConfig(
        name=name, vocab_size=V, hidden_size=D, intermediate_size=F,
        num_layers=L, num_heads=H, num_kv_heads=HK, head_dim=D // H,
        rope_theta=theta, rms_norm_eps=1e-6, max_position_embeddings=max_pos,
        qk_norm=False, attention_bias=True, tie_word_embeddings=tie,
    )


def _qwen3(name, V, D, F, L, H, HK, head_dim=128, max_pos=32768) -> ModelConfig:
    return ModelConfig(
        name=name, vocab_size=V, hidden_size=D, intermediate_size=F,
        num_layers=L, num_heads=H, num_kv_heads=HK, head_dim=head_dim,
        rope_theta=1e6, rms_norm_eps=1e-6, max_position_embeddings=max_pos,
        qk_norm=True, attention_bias=False, tie_word_embeddings=False,
    )


PRESETS: dict = {
    # Qwen2 (baseline configs 1-2)
    "qwen2-0.5b": _qwen2("qwen2-0.5b", 151936, 896, 4864, 24, 14, 2, tie=True),
    "qwen2-1.5b": _qwen2("qwen2-1.5b", 151936, 1536, 8960, 28, 12, 2, tie=True),
    "qwen2-7b": _qwen2("qwen2-7b", 152064, 3584, 18944, 28, 28, 4),
    # Qwen2.5 (baseline configs 3-5) — same arch family as Qwen2
    "qwen2.5-0.5b": _qwen2("qwen2.5-0.5b", 151936, 896, 4864, 24, 14, 2, tie=True),
    "qwen2.5-1.5b": _qwen2("qwen2.5-1.5b", 151936, 1536, 8960, 28, 12, 2, tie=True),
    "qwen2.5-3b": _qwen2("qwen2.5-3b", 151936, 2048, 11008, 36, 16, 2, tie=True),
    "qwen2.5-7b": _qwen2("qwen2.5-7b", 152064, 3584, 18944, 28, 28, 4),
    "qwen2.5-14b": _qwen2("qwen2.5-14b", 152064, 5120, 13824, 48, 40, 8, max_pos=131072),
    "qwen2.5-32b": _qwen2("qwen2.5-32b", 152064, 5120, 27648, 64, 40, 8, max_pos=131072),
    # Qwen3 — the reference's model is Qwen3-14B (SURVEY.md model identity)
    "qwen3-0.6b": _qwen3("qwen3-0.6b", 151936, 1024, 3072, 28, 16, 8),
    "qwen3-1.7b": _qwen3("qwen3-1.7b", 151936, 2048, 6144, 28, 16, 8),
    "qwen3-4b": _qwen3("qwen3-4b", 151936, 2560, 9728, 36, 32, 8),
    "qwen3-8b": _qwen3("qwen3-8b", 151936, 4096, 12288, 36, 32, 8),
    "qwen3-14b": _qwen3("qwen3-14b", 151936, 5120, 17408, 40, 40, 8),
    # Qwen3 MoE (128 experts, top-8, per-layer sparse MLP)
    "qwen3-30b-a3b": _qwen3("qwen3-30b-a3b", 151936, 2048, 6144, 48, 32,
                            4).replace(num_experts=128, num_experts_per_tok=8,
                                       moe_intermediate_size=768),
    "qwen3-235b-a22b": _qwen3("qwen3-235b-a22b", 151936, 4096, 12288, 94, 64,
                              4).replace(num_experts=128,
                                         num_experts_per_tok=8,
                                         moe_intermediate_size=1536),
    "qwen3-32b": _qwen3("qwen3-32b", 151936, 5120, 25600, 64, 64, 8),
}


def tiny_config(
    vocab_size: int = 512,
    hidden_size: int = 128,
    intermediate_size: int = 256,
    num_layers: int = 2,
    num_heads: int = 4,
    num_kv_heads: int = 2,
    head_dim: int = 32,
    qk_norm: bool = False,
    **kw,
) -> ModelConfig:
    """A small config for tests (CPU-fast, HF-parity friendly)."""
    return ModelConfig(
        name="tiny", vocab_size=vocab_size, hidden_size=hidden_size,
        intermediate_size=intermediate_size, num_layers=num_layers,
        num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
        rope_theta=1e4, rms_norm_eps=1e-6, max_position_embeddings=2048,
        qk_norm=qk_norm, attention_bias=not qk_norm,
        eos_token_ids=(1,), **kw,
    )
