"""Launches of the program's kernel wrappers (its ``_build.LAUNCHES``
counters over the window) per kept draw."""

UNIT = "count"


def read(t):
    return sum(t.launches.values()) / t.draws if t.draws else None
