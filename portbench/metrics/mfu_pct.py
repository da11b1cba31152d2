"""The whole window's share of the card's float32 peak: the least operations
of every evaluation in the window (sampler, Z steps, warm starts) over the
window's seconds times the peak."""

from portbench.counts import PEAK_F32_OPS

UNIT = "%"
CALLS = ("sample_hypers", "optimize_Z", "warm_start")


def read(t):
    ops = sum(t.ops(c) for c in CALLS)
    return 100.0 * ops / (t.window_s * PEAK_F32_OPS) if ops > 0 else None
