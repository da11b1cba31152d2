"""The sampler's share of its roofline: the least operations of its
evaluations (one bound with gradient per leapfrog) over the device busy time
inside the sample_hypers spans, against the float32 peak."""

from portbench.counts import PEAK_F32_OPS

UNIT = "%"


def read(t):
    busy = t.busy_in("sample_hypers")
    return 100.0 * t.ops("sample_hypers") / (busy * PEAK_F32_OPS) if busy > 0 else None
