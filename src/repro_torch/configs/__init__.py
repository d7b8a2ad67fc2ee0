"""Architecture registry of the port: ``--arch <id>`` ids map 1:1 to the
reference's ten archs."""
from repro_torch.models.base import register

from . import (deepseek_moe_16b, grok1_314b, hymba_1p5b, llama3p2_1b,
               llava_next_34b, minicpm3_4b, qwen3_8b, rwkv6_1p6b,
               stablelm_12b, whisper_tiny)
from .base import INPUT_SHAPES, LONG_CTX_SWA_WINDOW, InputShape  # noqa: F401

ARCH_MODULES = {
    "minicpm3-4b": minicpm3_4b,
    "grok-1-314b": grok1_314b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "hymba-1.5b": hymba_1p5b,
    "stablelm-12b": stablelm_12b,
    "llava-next-34b": llava_next_34b,
    "whisper-tiny": whisper_tiny,
    "qwen3-8b": qwen3_8b,
    "llama3.2-1b": llama3p2_1b,
    "rwkv6-1.6b": rwkv6_1p6b,
}

for _id, _mod in ARCH_MODULES.items():
    register(_id, lambda smoke=False, _m=_mod: _m.make(smoke=smoke))

# dense archs whose long_500k decode uses the sliding-window variant
LONG_CTX_SWA_ARCHS = {"minicpm3-4b", "stablelm-12b", "qwen3-8b", "llama3.2-1b"}
# archs for which long_500k is skipped (pure full attention, no SWA variant)
LONG_CTX_SKIP = {"grok-1-314b", "deepseek-moe-16b", "llava-next-34b",
                 "whisper-tiny"}
