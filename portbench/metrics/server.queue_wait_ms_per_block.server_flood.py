"""Host ms a block that the server loop waits to hand a batch to its
publisher worker, in the traced flood window: the ``server.queue_wait``
spans (the bounded put), summed over the window, over the blocks served.
None where the program records no spans, or dropped some."""


def read(run):
    try:
        from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS
    except ImportError:   # a program without spans
        return None
    return SPANS.ms_per("server.queue_wait", run.data.get("t0"), run.data.get("blocks", 0))
