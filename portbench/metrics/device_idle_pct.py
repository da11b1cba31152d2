"""The share of the traced window in which no operation ran on the card."""

UNIT = "%"


def read(t):
    w = t.traced_window_s
    return 100.0 * (1.0 - t.busy_s / w) if w > 0 and t.busy_s > 0 else None
