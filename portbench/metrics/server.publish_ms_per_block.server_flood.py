"""Host ms a block of the publisher worker's frame assembly, publish and
telemetry ring, in the traced flood window: the ``server.publish`` spans,
summed over the window, over the blocks served. None where the program
records no spans, or dropped some."""


def read(run):
    try:
        from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS
    except ImportError:   # a program without spans
        return None
    return SPANS.ms_per("server.publish", run.data.get("t0"), run.data.get("blocks", 0))
