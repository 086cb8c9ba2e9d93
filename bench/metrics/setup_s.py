"""setup_s: seconds from the process's start to the window's: imports,
the kernels' build where it is not cached, inputs, plans, warm-up."""


def read(run):
    return run.setup_s
