from qwen_inference_engine_tpu_torch.loader.convert import params_from_state_dict  # noqa: F401
from qwen_inference_engine_tpu_torch.loader.safetensors_loader import (  # noqa: F401
    load_checkpoint,
    parse_safetensors_header,
    SafetensorsIndex,
)
