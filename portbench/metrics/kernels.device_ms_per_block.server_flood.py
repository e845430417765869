"""Summed device kernel time a block in the traced flood window, in ms."""

from portbench.readings import per_block


def read(run):
    return per_block(run, "kernel_s", 1e3)
