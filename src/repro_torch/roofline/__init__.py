from .analysis import (RooflineReport, StepCost, analyze_step,  # noqa: F401
                       count_step, model_flops)
