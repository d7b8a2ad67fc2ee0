"""Host-side run telemetry of the port: the per-eval fairness frame (with
its network tiers), the JSONL sink, run manifests and content
fingerprints."""
from .evalframe import EvalFrame, compute_eval_frame, tiers_of  # noqa: F401
from .sink import (JsonlSink, RunManifest, bench_stamp,  # noqa: F401
                   fingerprint, read_jsonl)
