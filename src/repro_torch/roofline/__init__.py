"""The port's roofline (counterpart of ``repro/roofline``): a dispatch-level
cost walker (``op_cost``) and the three-term roofline on one H100
(``analysis``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    H100, HW, CellRoofline, Work, analyze_program, collective_bytes,
)
