"""kernels.us_per_layer_step: the device's busy time a call in the traced
window, over the call's time steps and layers (µs)."""


def read(run):
    done = run.done
    if run.trace is None or not done:
        return None
    return run.trace.busy_s / len(done) / (run.steps * run.layers) * 1e6
