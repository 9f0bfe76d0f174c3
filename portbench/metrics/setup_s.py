"""setup_s: process start to the first timed call (host clock): imports,
the CUDA context, the cell's kernels built or loaded, the warm-up call and
the first configuration's gauge."""


def read(run):
    return run.setup_s
