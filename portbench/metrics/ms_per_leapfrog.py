"""Milliseconds a leapfrog step of one chain takes: the sample_hypers spans'
host time over the leapfrogs of one chain (all chains' over the chain count)."""

UNIT = "ms"


def read(t):
    spans = t.spans("sample_hypers")
    per_chain = sum(t.leapfrogs(s) / s.info["chains"] for s in spans)
    return 1e3 * sum(s.seconds for s in spans) / per_chain if per_chain else None
