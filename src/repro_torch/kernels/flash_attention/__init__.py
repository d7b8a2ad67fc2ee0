from .ops import HEAD_DIMS, flash_attention  # noqa: F401
from .ref import attention_ref  # noqa: F401
