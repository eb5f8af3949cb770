"""Assigned input shapes (the JAX package's ``configs/shapes.py``).

  train_4k     training       seq 4,096    global batch 256
  prefill_32k  inference      seq 32,768   global batch 32
  decode_32k   decode         KV 32,768    global batch 128 (1 new token)
  long_500k    long decode    KV 524,288   global batch 1   (1 new token)
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}
