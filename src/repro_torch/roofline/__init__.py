from repro_torch.roofline.analysis import (
    HW,
    analyze_trace,
    model_flops,
    param_counts,
)

__all__ = ["HW", "analyze_trace", "model_flops", "param_counts"]
