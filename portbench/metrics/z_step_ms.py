"""Milliseconds an optimize_Z Adam step takes: the optimize_Z spans' host
time over their steps."""

UNIT = "ms"


def read(t):
    spans = t.spans("optimize_Z")
    steps = sum(s.info["steps"] for s in spans)
    return 1e3 * sum(s.seconds for s in spans) / steps if steps else None
