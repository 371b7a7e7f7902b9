"""What a per-layer metric's reader is given (``metrics/<name>.py``:
``read(ctx) -> float | None``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Context:
    trace: object  # trace.Trace of the traced window
    work: dict  # counts.window_least over the traced window: {piece: least seconds}
    steps: int  # train steps in the traced window
    host_cpu_s_per_step: float  # process CPU seconds a step, untraced window
    wall_s_per_step: float  # wall seconds a step, untraced window
