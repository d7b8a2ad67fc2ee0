from .analysis import (RooflineReport, StepCost, analyze_step,  # noqa: F401
                       collective_bytes_from_trace, count_step,
                       model_flops)
