"""Output samples a second of back-to-back ``align_offline`` calls: (T - 1)
x N x L a call, times the calls completed in the window, over the window's
seconds up to its closing ``torch.cuda.synchronize()``."""


def read(run):
    d = run.data
    if "calls" not in d or d["wall_s"] <= 0:
        return None
    return (d["T"] - 1) * d["n_channels"] * d["block_len"] * d["calls"] / d["wall_s"]
