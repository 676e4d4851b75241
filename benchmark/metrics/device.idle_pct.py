"""device.idle_pct: the share of the traced window in which the card ran no
kernel, copy or set (%)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
