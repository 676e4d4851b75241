"""kernels_roofline: the calls' least time on the H100 (the larger of their
FLOPs over 67 TFLOP/s and their bytes over 3.35 TB/s, counts/lstm.py) over
the time the device was busy with their kernels, copies and sets in the
traced window (%)."""


def read(run):
    if run.trace is None or not run.done or run.trace.busy_s <= 0:
        return None
    return 100.0 * sum(c.bound_s for c in run.done) / run.trace.busy_s
