"""entry.host_ms: the host's time inside the entry point, from the call to
``predict`` to its return, before the output is read back (mean over the
traced window's calls; host clock, the benchmark's own span)."""


def read(run):
    done = run.done
    if not done:
        return None
    return sum(c.t_ret - c.t0 for c in done) / len(done) * 1e3
