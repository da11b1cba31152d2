"""What a traced run reads: the profiler's device events, the benchmark's
spans and the program's counters, in one object the per-layer metric readers
(``metrics/<name>.py``) take.

Device busy time is the union of the intervals of the events the profiler
traced on the card (kernels and copies; not the spans' own annotations on the
device's timeline), so nothing is counted twice
(chip_smoke.py's ``device_breakdown``, copied); busy time inside a span is
that union clipped to the span.
"""

from __future__ import annotations

import collections

from .counts import bound_ops

__all__ = ["Traced", "union"]


def union(intervals):
    """The sorted, disjoint union of (t0, t1) intervals."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _clipped(busy, t0, t1):
    return sum(max(0.0, min(b1, t1) - max(b0, t0)) for b0, b1 in busy)


class Traced:
    """A finished window: ``run`` (driver.Run), ``launches`` (the program's
    launch counters over the window), and with ``prof`` the profiler's
    events (times in microseconds)."""

    def __init__(self, run, window_s, launches, prof=None):
        self.run = run
        self.window_s = window_s
        self.launches = launches
        n, d = run.X.shape
        self.n, self.d, self.m = n, d, run.Z0.shape[0]
        self.draws = run.draws()
        self.busy, self.cpu_spans, self.kernels, self.win = [], [], {}, None
        if prof is None:
            return
        from torch.autograd import DeviceType
        dev = []
        by_name = collections.defaultdict(float)
        for e in prof.events():
            t0, t1 = e.time_range.start, e.time_range.end
            if e.name.startswith("pb."):      # a span (its copy on the device's timeline too)
                if e.device_type != DeviceType.CUDA:
                    self.cpu_spans.append((e.name[3:], t0, t1))
            elif e.device_type == DeviceType.CUDA:
                dev.append((t0, t1))
                by_name[e.name] += (t1 - t0) / 1e6
        wins = [(t0, t1) for name, t0, t1 in self.cpu_spans if name == "window"]
        self.win = wins[0] if wins else None
        if self.win is not None:
            w0, w1 = self.win
            dev = [(max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1]
        self.busy = union(dev)
        self.kernels = dict(by_name)

    # -- what the readers use ---------------------------------------------
    def spans(self, name):
        """The window's spans of call ``name`` (host clock, with records)."""
        return self.run.rec.of(name)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    @property
    def traced_window_s(self) -> float:
        return (self.win[1] - self.win[0]) / 1e6 if self.win else 0.0

    def busy_in(self, name) -> float:
        """Device busy seconds inside the profiler's spans of call ``name``."""
        return sum(_clipped(self.busy, t0, t1) for n, t0, t1 in self.cpu_spans
                   if n == name) / 1e6

    def leapfrogs(self, span) -> float:
        """Warmup and sampling leapfrogs of all chains of a sample_hypers call."""
        st = span.info["stats"]
        return float(st["n_leapfrog"].sum()) + float(st["warmup_n_leapfrog"].sum())

    def ops(self, name) -> float:
        """The least operations of the evaluations the calls ``name`` of the
        window made: a leapfrog, a Z step of each trace row and a warm-start
        step each evaluate the bound once (the trainers with dU/dZ)."""
        n, m, d = self.n, self.m, self.d
        if name == "sample_hypers":
            return sum(self.leapfrogs(s) for s in self.spans(name)) * bound_ops(n, m, d)
        if name == "optimize_Z":
            return sum(s.info["steps"] * s.info["rows"] for s in self.spans(name)) \
                * bound_ops(n, m, d, want_z=True)
        if name == "warm_start":
            return sum(s.info["steps"] for s in self.spans(name)) * bound_ops(n, m, d, want_z=True)
        return 0.0

    # -- the traced run's breakdown ----------------------------------------
    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost call that was open on the host."""
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        gaps = collections.defaultdict(float)
        if self.win is not None:
            w0, w1 = self.win
            edges = [w0] + [x for b in self.busy for x in b] + [w1]
            inner = [(n, t0, t1) for n, t0, t1 in self.cpu_spans if n != "window"]
            for g0, g1 in zip(edges[0::2], edges[1::2]):
                if g1 <= g0:
                    continue
                mid = 0.5 * (g0 + g1)
                open_ = [(t1 - t0, n) for n, t0, t1 in inner if t0 <= mid <= t1]
                gaps[min(open_)[1] if open_ else "between calls"] += (g1 - g0) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}

