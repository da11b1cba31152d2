"""Milliseconds a warm-start Adam step takes: the warm_start spans' host time
over their steps."""

UNIT = "ms"


def read(t):
    spans = t.spans("warm_start")
    steps = sum(s.info["steps"] for s in spans)
    return 1e3 * sum(s.seconds for s in spans) / steps if steps else None
