from .ops import wkv, wkv_train  # noqa: F401
from .ref import wkv_scan  # noqa: F401
