from .ops import head_losses  # noqa: F401
from .ref import head_losses_ref  # noqa: F401
