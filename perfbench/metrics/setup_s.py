"""setup_s: from the process's start to the window's: imports, the kernels'
build or load, the weights, the KV slabs and replicas, the warm-up at the
cell's shapes, and an open loop's lead-in."""


def read(run):
    return run.setup_s
