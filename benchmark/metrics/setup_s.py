"""setup_s: from the start of the process to the first timed call: imports,
the kernel library (built by nvcc in the first run of a checkout, loaded
from build/kernels/ after), weights, surgery, inputs and the warm-up of the
cell's own shapes (host clock)."""


def read(run):
    return run.setup_s
