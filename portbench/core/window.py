"""What a measured window did."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    units: int  # steps or requests completed
    attempted: int
    failed: int
    window_s: float  # host clock, from the first call to the last completion
    latencies_s: list = dataclasses.field(default_factory=list)  # a request's call to its completion
    host_s: list = dataclasses.field(default_factory=list)  # a request's call to its return
