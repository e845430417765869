"""Device operations (kernels, copies, fills) a block in the traced flood
window: the step's fragmentation."""

from portbench.readings import per_block


def read(run):
    return per_block(run, "device_ops")
