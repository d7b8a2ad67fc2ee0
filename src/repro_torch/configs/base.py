"""The input-shape table of the architecture configs (mirrors
``repro.configs.base``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# dense archs that run long_500k via their sliding-window variant
LONG_CTX_SWA_WINDOW = 8_192
