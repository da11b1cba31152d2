"""optimize_Z's share of its roofline: the least operations of its
evaluations (one bound with dU/dZ per trace row and step) over the device busy
time inside the optimize_Z spans, against the float32 peak."""

from portbench.counts import PEAK_F32_OPS

UNIT = "%"


def read(t):
    busy = t.busy_in("optimize_Z")
    return 100.0 * t.ops("optimize_Z") / (busy * PEAK_F32_OPS) if busy > 0 else None
