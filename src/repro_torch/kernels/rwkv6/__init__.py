from .ops import wkv  # noqa: F401
from .ref import wkv_scan  # noqa: F401
