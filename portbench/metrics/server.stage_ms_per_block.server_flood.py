"""Host ms a block of staging in the traced flood window: the ``server.stage``
spans (pad to the runner's width, pinned copy, upload), summed over the
window, over the blocks served. None where the program records no spans,
or dropped some."""


def read(run):
    try:
        from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS
    except ImportError:   # a program without spans
        return None
    return SPANS.ms_per("server.stage", run.data.get("t0"), run.data.get("blocks", 0))
