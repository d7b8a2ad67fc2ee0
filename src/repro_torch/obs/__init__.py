"""Host-side run telemetry of the port: the per-eval fairness frame, the
JSONL sink, run manifests and content fingerprints."""
from .evalframe import EvalFrame, compute_eval_frame  # noqa: F401
from .sink import (JsonlSink, RunManifest, bench_stamp,  # noqa: F401
                   fingerprint, read_jsonl)
