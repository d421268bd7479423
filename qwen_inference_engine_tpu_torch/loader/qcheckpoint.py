"""Offline quantized checkpoints: pack once, reload without requantizing.

The port of the JAX package's ``loader/qcheckpoint.py``, in the same
on-disk format, so each package loads the other's output::

    qckpt/
      manifest.json     # format_version 1, model_config, quant, leaves
      <leaf-path>.npy   # one array per leaf; bf16 stored as uint16 with
                        # "dtype": "bfloat16" in the manifest

Leaf paths are the JAX package's pytree paths (``layers.q.q``,
``layers.q.scales``, ``layers.q.b``, ``lm_head.w``, ``embed``, ...); a
Qwen3-MoE model adds ``layers.router.w`` and the expert stacks
``layers.moe_gate`` (bf16) or ``layers.moe_gate.q`` / ``.scales``
(``[L, E, K/pack, N]`` and ``[L, E, K/gs, N]``), as the JAX package writes
them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear

_FORMAT_VERSION = 1
_LINEARS = ("q", "k", "v", "o", "gate", "up", "down", "router")
# Qwen3-MoE expert stacks: a bf16 tensor leaf [L, E, K, N] or a quantized
# one ([L, E, K/pack, N] bytes, [L, E, K/gs, N] scales)
_EXPERTS = ("moe_gate", "moe_up", "moe_down")
_NORMS = ("input_norm", "post_norm", "q_norm", "k_norm")


def _flat(params: dict):
    """(path, tensor) pairs in the JAX package's pytree order: dict keys
    sorted, dataclass fields in declaration order, None skipped."""
    def walk(prefix, v):
        if v is None:
            return
        if isinstance(v, torch.Tensor):
            yield prefix, v
        elif isinstance(v, dict):
            for k in sorted(v):
                yield from walk(f"{prefix}.{k}" if prefix else k, v[k])
        elif isinstance(v, (Linear, QuantLinear)):
            for f in dataclasses.fields(v):
                val = getattr(v, f.name)
                if isinstance(val, torch.Tensor):
                    yield from walk(f"{prefix}.{f.name}", val)
        else:
            raise TypeError(f"unexpected leaf {type(v)} at {prefix}")

    yield from walk("", params)


def save_quantized(ckpt_dir: str, cfg: ModelConfig, params: dict) -> None:
    """Write a (possibly quantized) param dict as a reloadable checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    quant_meta = {}
    for name, leaf in params["layers"].items():
        if isinstance(leaf, QuantLinear):
            quant_meta[f"layers.{name}"] = {"bits": leaf.bits,
                                            "group_size": leaf.group_size}
    if isinstance(params.get("lm_head"), QuantLinear):
        quant_meta["lm_head"] = {"bits": params["lm_head"].bits,
                                 "group_size": params["lm_head"].group_size}
    leaves = {}
    for name, t in _flat(params):
        fn = name + ".npy"
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:  # np.save has no bfloat16: store bits
            dtype_name = "bfloat16"
            a = t.view(torch.int16).numpy().view(np.uint16)
        else:
            a = t.numpy()
            dtype_name = str(a.dtype)
        np.save(os.path.join(ckpt_dir, fn), a)
        leaves[name] = {"file": fn, "dtype": dtype_name,
                        "shape": list(a.shape)}
    cfg_d = dataclasses.asdict(cfg)
    cfg_d["eos_token_ids"] = list(cfg_d.get("eos_token_ids", ()))
    manifest = {
        "format_version": _FORMAT_VERSION,
        "model_config": cfg_d,
        "quant": quant_meta,
        "leaves": leaves,
    }
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_quantized(ckpt_dir: str, device=None) -> Tuple[ModelConfig, dict]:
    """Load a checkpoint written by either package's ``save_quantized``,
    on the card unless ``device="cpu"``."""
    from qwen_inference_engine_tpu_torch.engine.engine import resolve_device

    device = resolve_device(device)
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported quantized checkpoint format "
                         f"{manifest.get('format_version')!r}")
    cfg_d = {k: v for k, v in manifest["model_config"].items()
             if k in ModelConfig.__dataclass_fields__}
    if "eos_token_ids" in cfg_d:
        cfg_d["eos_token_ids"] = tuple(cfg_d["eos_token_ids"])
    cfg = ModelConfig(**cfg_d)
    leaves = manifest["leaves"]

    def arr(name: str) -> torch.Tensor:
        info = leaves[name]
        a = np.load(os.path.join(ckpt_dir, info["file"]), mmap_mode="c")
        t = torch.from_numpy(a)
        if info["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device, copy=True)

    qmeta = manifest["quant"]

    def lin(prefix: str):
        b = arr(f"{prefix}.b") if f"{prefix}.b" in leaves else None
        if prefix in qmeta:
            return QuantLinear(q=arr(f"{prefix}.q"),
                               scales=arr(f"{prefix}.scales"), b=b,
                               bits=qmeta[prefix]["bits"],
                               group_size=qmeta[prefix]["group_size"])
        return Linear(w=arr(f"{prefix}.w"), b=b)

    layers = {}
    for nm in _LINEARS + _EXPERTS:
        prefix = f"layers.{nm}"
        if f"{prefix}.q" in leaves or f"{prefix}.w" in leaves:
            layers[nm] = lin(prefix)
        elif prefix in leaves:   # a bf16 expert stack
            layers[nm] = arr(prefix)
    for nm in _NORMS:
        if f"layers.{nm}" in leaves:
            layers[nm] = arr(f"layers.{nm}")
    params = {
        "layers": layers,
        "embed": arr("embed"),
        "final_norm": arr("final_norm"),
        "rope_cos": arr("rope_cos"),
        "rope_sin": arr("rope_sin"),
    }
    if "lm_head.q" in leaves or "lm_head.w" in leaves:
        params["lm_head"] = lin("lm_head")
    return cfg, params
