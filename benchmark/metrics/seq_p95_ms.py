"""seq_p95_ms: the 95th percentile (nearest rank) of all the window's
completed whole-run calls, each from its issue to its output on the host
(host clock). A failed call makes the run incorrect."""

from benchmark.core.record import percentile


def read(run):
    if not run.done:
        return None
    return percentile([(c.t_done - c.t0) * 1e3 for c in run.done], 95)
