"""Host ms a block that the publisher worker waits for a batch's outputs to
reach the host, in the traced flood window: the ``server.fetch_wait``
spans (the copy's ``synchronize``, which waits for the step on the card
too), summed over the window, over the blocks served. The worker is
invisible to torch.profiler: only the program's spans see it. None where
the program records no spans, or dropped some."""


def read(run):
    try:
        from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS
    except ImportError:   # a program without spans
        return None
    return SPANS.ms_per("server.fetch_wait", run.data.get("t0"), run.data.get("blocks", 0))
