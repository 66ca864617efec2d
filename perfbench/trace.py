"""What a run's metric readers read: the window's host-clock spans and, in a
traced run, the device intervals of ``torch.profiler``.

The profiler stamps its events on the wall clock in nanoseconds
(``time.time_ns``'s base); the window's spans are taken on
``time.perf_counter_ns`` and moved onto that base by one offset read when
the window opens.  Every call of the window ends with its answer on the
host, so the device work of a call lies inside its span.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

@dataclass
class Window:
    """One run's measured window.

    ``starts`` / ``ends``: every call's span, ns on the profiler's base;
    ``rows``: events answered per call; ``device``: (name, kind, start,
    end) of each device operation (ns, traced runs only)."""

    cfg: Mapping
    traffic: Mapping
    starts: np.ndarray
    ends: np.ndarray
    rows: int
    setup_s: float
    traced: bool = False
    device: List[Tuple[str, str, int, int]] = field(default_factory=list)

    @property
    def calls(self) -> int:
        return len(self.starts)

    @property
    def events(self) -> int:
        return self.calls * self.rows

    @property
    def window_s(self) -> float:
        return (int(self.ends[-1]) - int(self.starts[0])) * 1e-9

    @property
    def latencies_s(self) -> np.ndarray:
        return (self.ends - self.starts) * 1e-9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [(n, s, e) for n, k, s, e in self.device if k == "kernel"]

    def busy(self) -> np.ndarray:
        """The union of the device intervals, merged, as [k, 2] ns."""
        return merge([(s, e) for _, _, s, e in self.device])

    def busy_s(self) -> float:
        b = self.busy()
        return float((b[:, 1] - b[:, 0]).sum()) * 1e-9 if len(b) else 0.0


def merge(intervals) -> np.ndarray:
    """Overlapping [start, end) intervals merged into disjoint ones."""
    if not len(intervals):
        return np.zeros((0, 2), np.int64)
    a = np.asarray(sorted(intervals), np.int64)
    reach = np.maximum.accumulate(a[:, 1])
    new = np.ones(len(a), bool)
    new[1:] = a[1:, 0] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(a) - 1)
    return np.stack([a[first, 0], reach[last]], 1)


def device_events(prof) -> List[Tuple[str, str, int, int]]:
    """(name, kind, start_ns, end_ns) of every device operation a
    ``torch.profiler.profile`` recorded."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        low = name.lower()
        kind = ("memcpy" if "memcpy" in low else
                "memset" if "memset" in low else "kernel")
        out.append((name, kind, e.start_ns(), e.end_ns()))
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    base = name[:cut] if cut > 0 else name
    return base.removeprefix("void ")[:width]


def breakdown(win: Window, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the idle
    time of the device split by what the host was doing: inside a call
    before its first device operation, between two of them, after its
    last one, and between calls (the harness's loop)."""
    by_name: Dict[str, int] = {}
    for name, _, s, e in win.device:
        k = short_name(name)
        by_name[k] = by_name.get(k, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = win.busy()
    starts, ends = win.starts.astype(np.int64), win.ends.astype(np.int64)
    call = np.searchsorted(starts, busy[:, 0], side="right") - 1
    keep = (call >= 0) & (busy[:, 0] < ends[np.maximum(call, 0)])
    busy, call = busy[keep], call[keep]
    bs = np.clip(busy[:, 0], starts[call], ends[call])
    be = np.clip(busy[:, 1], starts[call], ends[call])
    # busy is sorted, so each call's intervals are one run of ``call``
    hit, first = np.unique(call, return_index=True)
    last = np.append(first[1:], len(call)) - 1
    wall = ends - starts
    inner = int((be - bs).sum())
    pre = int((bs[first] - starts[hit]).sum()
              + wall.sum() - wall[hit].sum())
    post = int((ends[hit] - be[last]).sum())
    idle = {"host before a call's first device op": pre,
            "host between device ops of a call":
                int((be[last] - bs[first]).sum()) - inner,
            "host after a call's last device op": post,
            "harness between calls": int((starts[1:] - ends[:-1]).sum())}
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v * 1e-9] for k, v in ops],
            "idle_gaps": [[k, v * 1e-9] for k, v in gaps]}


def percentile(values: np.ndarray, q: float) -> Optional[float]:
    """The ``q``-th percentile of every value (linear between ranks)."""
    return float(np.percentile(values, q)) if len(values) else None
