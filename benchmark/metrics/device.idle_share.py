"""device.idle_share: percent of the profiled window in which no kernel,
copy or set ran on the device: one minus the union of the device records'
intervals over the window between the last leading and the first trailing
filler kernel (`harness/trace.py`)."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
