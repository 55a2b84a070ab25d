"""Process start to the first measured request: loading, weights, kernel
builds, documents prefilled and the warm-up steps."""


def read(run):
    return run.setup_s
