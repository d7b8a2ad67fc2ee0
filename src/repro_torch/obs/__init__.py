"""Host-side run telemetry of the port (so far the per-eval fairness frame)."""
from .evalframe import EvalFrame, compute_eval_frame  # noqa: F401
