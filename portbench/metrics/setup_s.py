"""Set-up seconds: from the start of the run to the start of the window
(loading, the kernels' build or load, rendering the inputs, warm-up)."""


def read(run):
    return run.setup_s
