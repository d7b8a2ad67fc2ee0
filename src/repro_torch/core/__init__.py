"""FACADE (the paper's contribution) and the EL baseline, in PyTorch."""
from .bindings import Binding, make_binding  # noqa: F401
from .facade import (FacadeConfig, facade_round, final_allreduce,  # noqa: F401
                     node_models)
from .state import (BaselineState, FacadeState, init_baseline_state,  # noqa: F401
                    init_facade_state)
