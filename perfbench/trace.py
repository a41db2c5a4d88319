"""The traced run's reduction: torch.profiler events to one summary.

The profiler covers whole requests, each inside a `perfbench.request`
annotation; the traced window runs from the first such annotation's start
to the last one's end, in the profiler's own clock.  Device activities
(kernels, memory copies and sets) are read from the profiler's events in
memory.  `Summary` holds what the per-layer readers need: the kernels by
name (count and seconds), the device's busy time as the union of every
activity's interval inside the window (so it cannot exceed the window), the
longest idle gaps named by the innermost host operation running at their
middle, and the cycles the traced requests ran.
"""

from __future__ import annotations

from collections import defaultdict

REQUEST_SPAN = "perfbench.request"


def is_copy(name: str) -> bool:
    """A memory copy or set, not a kernel."""
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals, lo: int, hi: int):
    """The idle (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Summary:
    """The traced window reduced: `kernels` {name: [count, seconds]} for
    device kernels, `copies` likewise for copies and sets, `busy_s`,
    `window_s`, `cycles` (control cycles of the traced requests),
    `requests`, and the top `device_ops` and `idle_gaps` lists."""

    def __init__(self, device_events, host_events, cycles_per_request: int, top: int = 10):
        spans = [(s, e) for name, s, e in host_events if name == REQUEST_SPAN]
        if not spans:
            raise ValueError("the trace holds no request span")
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        self.requests = len(spans)
        self.cycles = self.requests * cycles_per_request
        self.window_s = (hi - lo) / 1e9
        inside = [(n, s, e) for n, s, e in device_events if s >= lo and e <= hi]
        self.kernels, self.copies = defaultdict(lambda: [0, 0.0]), defaultdict(lambda: [0, 0.0])
        for name, s, e in inside:
            slot = (self.copies if is_copy(name) else self.kernels)[name]
            slot[0] += 1
            slot[1] += (e - s) / 1e9
        intervals = [(s, e) for _, s, e in device_events]
        self.busy_s = union_ns(intervals, lo, hi) / 1e9
        ops = sorted(((n, v[1]) for n, v in {**self.kernels, **self.copies}.items()), key=lambda t: -t[1])
        self.device_ops = [[n, s] for n, s in ops[:top]]
        gaps = sorted(gaps_ns(intervals, lo, hi), key=lambda g: g[0] - g[1])[:top]
        self.idle_gaps = [[_host_at(host_events, (s + e) // 2), (e - s) / 1e9] for s, e in gaps]

    def kernel_stats(self, match=None, exclude=None):
        """(launches, seconds) of the kernels whose name holds `match` (all
        if None) and not `exclude`."""
        n, t = 0, 0.0
        for name, (count, secs) in self.kernels.items():
            if (match is None or match in name) and (exclude is None or exclude not in name):
                n, t = n + count, t + secs
        return n, t


def _host_at(host_events, t: int) -> str:
    """The innermost host operation (other than the request span) running
    at time t, or "host idle"."""
    best, width = "host idle", None
    for name, s, e in host_events:
        if s <= t <= e and name != REQUEST_SPAN and (width is None or e - s < width):
            best, width = name, e - s
    return best


def read_events(prof):
    """(device events, host events) of a finished profiler as lists of
    (name, start ns, end ns)."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        item = (ev.name(), ev.start_ns(), ev.end_ns())
        if ev.device_type() != DeviceType.CUDA:
            host.append(item)
        elif ev.name() != REQUEST_SPAN:  # the device's own activities, not the span's shadow there
            device.append(item)
    return device, host
