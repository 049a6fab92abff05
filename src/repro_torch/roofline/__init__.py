"""Roofline analysis of traced steps on an H100 (see ``analysis``)."""
from repro_torch.roofline.analysis import (
    HW_H100,
    CellReport,
    active_params,
    analyze_traced,
    model_flops,
    trace_step,
)

__all__ = ["HW_H100", "CellReport", "active_params", "analyze_traced", "model_flops",
           "trace_step"]
