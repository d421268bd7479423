"""HF checkpoint tensor names -> the port's layer-stacked params.

The port of the JAX package's ``loader/convert.py``: each per-layer weight
is stacked along a leading layer axis, and projection matrices go from HF
row-major ``[out, in]`` to matmul-ready ``[in, out]``.  Each tensor goes to
the target device on its own, is transposed and cast there, and is copied
into its preallocated stacked slab, so the host never holds more than the
one tensor being read (the JAX package's threaded host transposes of
``loader/native.py`` have no counterpart: the card does them).  A
Qwen3-MoE checkpoint's ``mlp.gate`` becomes the ``router`` Linear
``[L, D, E]`` and its ``mlp.experts.{e}.{gate,up,down}_proj`` the expert
stacks ``[L, E, in, out]``, filled one expert tensor at a time.
"""

from __future__ import annotations

from typing import Callable, Mapping, Union

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.ops.linear import Linear
from qwen_inference_engine_tpu_torch.ops.rope import precompute_rope


def as_tensor(a) -> torch.Tensor:
    """A torch view of a tensor, a numpy array or an ``ml_dtypes`` bf16
    array (through a ``uint16`` view, without importing ``ml_dtypes``)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_state_dict(
    cfg: ModelConfig,
    get: Union[Callable[[str], object], Mapping[str, object]],
    dtype=torch.bfloat16,
    device=None,
) -> dict:
    """Build the model params from HF-named tensors.

    ``get`` is a mapping (a torch ``state_dict()``) or a callable
    ``name -> tensor or array`` (a lazy safetensors reader).  The params
    land on ``device``: the card unless ``device="cpu"``."""
    from qwen_inference_engine_tpu_torch.engine.engine import resolve_device

    if not callable(get):
        mapping = get
        get = lambda name: mapping[name]  # noqa: E731
    device = resolve_device(device)

    def put(name: str, out=None, transpose: bool = False) -> torch.Tensor:
        t = as_tensor(get(name)).to(device)
        if transpose:
            t = t.t()
        if out is None:
            out = torch.empty(t.shape, dtype=dtype, device=device)
        out.copy_(t)
        return out

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        first = put(fmt.format(i=0), transpose=transpose)
        out = torch.empty((cfg.num_layers, *first.shape), dtype=dtype,
                          device=device)
        out[0] = first
        del first
        for i in range(1, cfg.num_layers):
            put(fmt.format(i=i), out[i], transpose)
        return out

    def stack_linear(prefix: str, has_bias: bool) -> Linear:
        w = stack(prefix + ".weight", transpose=True)
        b = stack(prefix + ".bias") if has_bias else None
        return Linear(w, b)

    L = "model.layers.{i}."
    bias = cfg.attention_bias
    layers = {
        "input_norm": stack(L + "input_layernorm.weight"),
        "q": stack_linear(L + "self_attn.q_proj", bias),
        "k": stack_linear(L + "self_attn.k_proj", bias),
        "v": stack_linear(L + "self_attn.v_proj", bias),
        "o": stack_linear(L + "self_attn.o_proj", False),
        "post_norm": stack(L + "post_attention_layernorm.weight"),
    }
    if cfg.is_moe:
        # Qwen3-MoE: mlp.gate [E, D] is the router; mlp.experts.{e}.*_proj
        # [out, in] go to [L, E, in, out] stacks, one expert at a time
        def stack_experts(proj: str) -> torch.Tensor:
            fmt = "model.layers.{i}.mlp.experts.{e}." + proj + ".weight"
            first = put(fmt.format(i=0, e=0), transpose=True)
            out = torch.empty((cfg.num_layers, cfg.num_experts, *first.shape),
                              dtype=dtype, device=device)
            out[0, 0] = first
            del first
            for i in range(cfg.num_layers):
                for e in range(cfg.num_experts):
                    if i or e:
                        put(fmt.format(i=i, e=e), out[i, e], True)
            return out

        layers["router"] = stack_linear(L + "mlp.gate", False)
        layers["moe_gate"] = stack_experts("gate_proj")
        layers["moe_up"] = stack_experts("up_proj")
        layers["moe_down"] = stack_experts("down_proj")
    else:
        layers["gate"] = stack_linear(L + "mlp.gate_proj", False)
        layers["up"] = stack_linear(L + "mlp.up_proj", False)
        layers["down"] = stack_linear(L + "mlp.down_proj", False)
    if cfg.qk_norm:
        layers["q_norm"] = stack(L + "self_attn.q_norm.weight")
        layers["k_norm"] = stack(L + "self_attn.k_norm.weight")
    cos, sin = precompute_rope(cfg.max_position_embeddings, cfg.head_dim,
                               cfg.rope_theta, device=device)
    params = {
        "embed": put("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": put("model.norm.weight"),
        "rope_cos": cos,
        "rope_sin": sin,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = Linear(put("lm_head.weight", transpose=True))
    return params
