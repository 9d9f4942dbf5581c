"""The reduction of a profiler trace (torch.profiler's Chrome JSON) of a
traced window to what the per-layer metrics read.

A device record is a kernel, a memcpy or a memset. A kernel's time a unit
(a step or a request) follows the port's F14 arithmetic
(utils/timing.device_time_ms, copied): the profiler may drop records, so
a kernel's time a launch is its total over the records kept, and its
launches a unit are its records over the units rounded up (a dropped
record only lowers the count). Kernels whose record count is no multiple
of the units are listed in `dropped`.

A kernel is attributed to the host code that launched it through its
correlation id: the runtime call (cudaLaunchKernel, cuLaunchKernel, ...)
with the same id, and the host ranges (user annotations such as
torch.optim's "Optimizer.step#Adam.step") that contain that call.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host records of the CUDA API (runtime and lower-level launch calls) are
#: the categories that start with this.
CUDA_API = "cuda_"
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "portbench.window"


@dataclasses.dataclass(frozen=True)
class Rec:
    name: str
    cat: str
    ts: float  # us
    dur: float  # us
    tid: object = None
    corr: int | None = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


def kernel_base_name(name: str) -> str:
    """`void (anonymous namespace)::k_bwd_fields<false, false>(float const*, ...)`
    -> `k_bwd_fields`: the last identifier before the template arguments
    and the parameter list."""
    name = name.replace("(anonymous namespace)", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            cut = i
            break
    head = name[:cut]
    while re.search(r"<[^<>]*>", head):
        head = re.sub(r"<[^<>]*>", "", head)
    words = head.split("::")[-1].split()
    return words[-1] if words else head


class Trace:
    """The records of one traced window of `units` steps or requests."""

    def __init__(self, events: list, units: int, host_window_s: float | None = None):
        self.units = units
        self.records = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            args = e.get("args") or {}
            corr = args.get("correlation")
            self.records.append(Rec(str(e.get("name", "")), str(e.get("cat", "")), float(e["ts"]),
                                    float(e["dur"]), e.get("tid"), int(corr) if corr is not None else None))
        self.device = [r for r in self.records if r.cat in DEVICE_CATS]
        self.kernels = [r for r in self.device if r.cat == "kernel"]
        self.launch = {r.corr: r for r in self.records if r.cat.startswith(CUDA_API) and r.corr is not None}
        self.annotations = [r for r in self.records if r.cat == "user_annotation"]
        win = [r for r in self.annotations if r.name == WINDOW]
        self.window = win[0] if win else None
        self.host_window_s = host_window_s

    @classmethod
    def from_chrome(cls, path_or_dict, units: int, host_window_s: float | None = None) -> "Trace":
        data = path_or_dict
        if not isinstance(data, dict):
            with open(data) as f:
                data = json.load(f)
        return cls(data.get("traceEvents", []), units, host_window_s)

    # -- the window and the device's busy time ---------------------------

    @property
    def window_s(self) -> float:
        """The traced window's length: its annotation on the trace's clock,
        else the host's clock."""
        if self.window is not None:
            return self.window.dur / 1e6
        return self.host_window_s

    def _span(self) -> tuple[float, float]:
        if self.window is not None:
            return self.window.ts, self.window.end
        if not self.device:
            return 0.0, 0.0
        return min(r.ts for r in self.device), max(r.end for r in self.device)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device records, clipped to the window (us)."""
        lo, hi = self._span()
        ivs = sorted((max(r.ts, lo), min(r.end, hi)) for r in self.device if r.end > lo and r.ts < hi)
        out = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    # -- kernels a unit ---------------------------------------------------

    def _groups(self, select):
        groups = defaultdict(lambda: [0, 0.0])
        for r in self.kernels:
            if select(r):
                g = groups[r.name]
                g[0] += 1
                g[1] += r.dur
        return groups

    def per_unit_ms(self, select) -> float | None:
        """Device ms a unit in the kernels `select(rec)` takes; None where
        the trace holds none of them."""
        groups = self._groups(select)
        if not groups or self.units < 1:
            return None
        return sum(total / count * math.ceil(count / self.units) for count, total in groups.values()) / 1e3

    def launches_per_unit(self, select=lambda r: True) -> int | None:
        groups = self._groups(select)
        if not groups or self.units < 1:
            return None
        return sum(math.ceil(count / self.units) for count, _ in groups.values())

    def dropped(self) -> list[str]:
        return sorted(n for n, (count, _) in self._groups(lambda r: True).items() if count % self.units)

    def launched_under(self, rec: Rec, prefix: str) -> bool:
        """Whether the host call that launched `rec` ran inside a host range
        whose name starts with `prefix`."""
        call = self.launch.get(rec.corr)
        if call is None:
            return False
        return any(a.name.startswith(prefix) and a.tid == call.tid and a.ts <= call.ts <= a.end
                   for a in self.annotations)

    # -- the breakdown: the device operations and the idle gaps -------------

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, [name, seconds],
        longest first."""
        ops = defaultdict(float)
        for r in self.device:
            ops[r.name] += r.dur / 1e6
        return [[n, s] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle gaps summed by what the host was doing (the innermost
        host range around the gap's middle on the window's thread),
        [name, seconds], longest first."""
        gaps = defaultdict(float)
        lo, hi = self._span()
        tid = self.window.tid if self.window is not None else None
        host = [r for r in self.records if (r.cat in HOST_CATS or r.cat.startswith(CUDA_API)) and r.name != WINDOW
                and (tid is None or r.tid == tid)]
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            around = [r for r in host if r.ts <= mid <= r.end]
            name = max(around, key=lambda r: r.ts).name if around else "(no host range)"
            gaps[name] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
