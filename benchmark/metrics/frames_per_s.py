"""frames_per_s: every 16-sample frame the window's completed calls
processed, over all the time of the window (host clock, from its opening to
the last output on the host)."""


def read(run):
    if not run.done:
        return None
    return sum(c.frames for c in run.done) / run.window_s
