"""Sharded safetensors checkpoint reader.

The port of the JAX package's ``loader/safetensors_loader.py``.  The
header of each shard is parsed here (8-byte little-endian length, then a
JSON header), so no ``safetensors`` package is needed; shards come from
``model.safetensors.index.json`` or, without one, from the directory
listing.  Tensors are ``np.memmap`` views of their shard (BF16 through a
``uint16`` view, without ``ml_dtypes``) that go to the device one at a
time (``loader/convert.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.loader.convert import params_from_state_dict

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": np.uint16,  # viewed as torch.bfloat16
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


@dataclasses.dataclass
class TensorEntry:
    """One tensor record of a safetensors JSON header."""

    name: str
    dtype: str
    shape: Tuple[int, ...]
    start: int  # byte offset within the shard's data section
    end: int
    file: str


def parse_safetensors_header(path: str) -> Tuple[List[TensorEntry], int]:
    """Parse one shard's header. Returns (entries, data_section_offset)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    data_off = 8 + header_len
    entries = []
    for name, rec in header.items():
        if name == "__metadata__":
            continue
        s, e = rec["data_offsets"]
        entries.append(
            TensorEntry(name, rec["dtype"], tuple(rec["shape"]), s, e, path))
    return entries, data_off


class SafetensorsIndex:
    """Name -> (shard file, offsets) index over a sharded HF checkpoint dir."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self.entries: Dict[str, TensorEntry] = {}
        self._data_off: Dict[str, int] = {}
        self._mmaps: Dict[str, np.memmap] = {}
        files = self._shard_files(ckpt_dir)
        if not files:
            raise FileNotFoundError(f"no .safetensors shards under {ckpt_dir}")
        for path in files:
            entries, data_off = parse_safetensors_header(path)
            self._data_off[path] = data_off
            for e in entries:
                self.entries[e.name] = e

    @staticmethod
    def _shard_files(ckpt_dir: str) -> List[str]:
        idx_path = os.path.join(ckpt_dir, "model.safetensors.index.json")
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                wm = json.load(f)["weight_map"]
            return sorted({os.path.join(ckpt_dir, v) for v in wm.values()})
        return sorted(
            os.path.join(ckpt_dir, f)
            for f in os.listdir(ckpt_dir)
            if f.endswith(".safetensors"))

    def names(self) -> List[str]:
        return sorted(self.entries)

    def _mmap(self, path: str) -> np.memmap:
        if path not in self._mmaps:
            # copy-on-write: torch takes the view as writable, the file
            # is never written
            self._mmaps[path] = np.memmap(path, dtype=np.uint8, mode="c")
        return self._mmaps[path]

    def read(self, name: str) -> torch.Tensor:
        """A CPU tensor viewing the tensor's bytes in its shard (no copy)."""
        e = self.entries[name]
        if e.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {e.dtype} of {name}")
        mm = self._mmap(e.file)
        base = self._data_off[e.file]
        arr = mm[base + e.start: base + e.end].view(_DTYPES[e.dtype])
        t = torch.from_numpy(arr)
        if e.dtype == "BF16":
            t = t.view(torch.bfloat16)
        return t.reshape(e.shape)

    def close(self):
        self._mmaps.clear()


def load_checkpoint(ckpt_dir: str, cfg: Optional[ModelConfig] = None,
                    dtype=torch.bfloat16, device=None) -> Tuple[ModelConfig, dict]:
    """Load an HF Qwen checkpoint directory into the port's params, on the
    card unless ``device="cpu"``."""
    if cfg is None:
        cfg = ModelConfig.from_json(os.path.join(ckpt_dir, "config.json"),
                                    name=os.path.basename(ckpt_dir))
    index = SafetensorsIndex(ckpt_dir)
    try:
        params = params_from_state_dict(cfg, index.read, dtype=dtype,
                                        device=device)
    finally:
        index.close()
    return cfg, params
