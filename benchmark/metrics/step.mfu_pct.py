"""step.mfu_pct: the model FLOPs of the window's completed calls (the
model's own form, counts/lstm.py) over the window's time at the H100's
published float32 peak, 67 TFLOP/s (%)."""

from benchmark.counts.lstm import PEAK_FLOPS


def read(run):
    if not run.done:
        return None
    return 100.0 * sum(c.flops for c in run.done) / (run.window_s * PEAK_FLOPS["float32"])
