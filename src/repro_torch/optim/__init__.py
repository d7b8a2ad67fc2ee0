from .optimizers import (Optimizer, adamw, apply_updates, momentum,  # noqa: F401
                         sgd)
from .schedules import constant, cosine_warmup  # noqa: F401
from .wrappers import (accumulate_gradients, clip_by_global_norm,  # noqa: F401
                       master_weights)
