"""Leapfrog steps (warmup and sampling, all chains) per kept draw, from the
sampler's own counts (``stats["n_leapfrog"]``, ``stats["warmup_n_leapfrog"]``)."""

UNIT = "count"


def read(t):
    spans = t.spans("sample_hypers")
    return sum(t.leapfrogs(s) for s in spans) / t.draws if t.draws else None
