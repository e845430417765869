"""Signal samples a second the server delivered: frames the sink received
inside the window x N x L, over the window's seconds (the reference channel
is not counted)."""

from portbench.readings import frames_by_end


def read(run):
    d = run.data
    if "recv" not in d:
        return None
    return frames_by_end(run) * d["n_channels"] * d["block_len"] / run.seconds
