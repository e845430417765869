"""The card's idle share over the traced flood window: 1 - (union of kernel
and copy intervals on all streams) / window."""

from portbench.readings import idle_share


def read(run):
    return idle_share(run)
