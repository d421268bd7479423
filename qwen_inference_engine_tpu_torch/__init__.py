"""PyTorch + CUDA port of the Qwen inference engine, for one NVIDIA H100.

The JAX package ``qwen_inference_engine_tpu`` stays beside this one as the
reference; this package imports nothing of it and nothing of JAX.  Module
names follow the JAX package, so each module's counterpart is easy to find.

This slice covers dense Qwen2/2.5/3 generation through ``Engine.generate``
over the contiguous KV cache, W4A8 (INT4 weights, per-token int8
activations) with bf16 KV.  Its four kernels are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``ops/cuda_lib.py``).  Every kernel wrapper launches its kernel for a CUDA
tensor and runs the plain PyTorch version beside it only for a CPU tensor.
"""

__version__ = "0.1.0"

from qwen_inference_engine_tpu_torch.config import PRESETS, ModelConfig  # noqa: F401
