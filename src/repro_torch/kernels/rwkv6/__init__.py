from .ops import wkv, wkv_backward, wkv_train  # noqa: F401
from .ref import wkv_backward_scan, wkv_scan  # noqa: F401
