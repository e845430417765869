"""Host ms a block of the step's dispatch in the traced flood window: the
``server.dispatch`` spans (the packed step's Python and PyTorch calls and
the kernels' launches), summed over the window, over the blocks served.
None where the program records no spans, or dropped some."""


def read(run):
    try:
        from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS
    except ImportError:   # a program without spans
        return None
    return SPANS.ms_per("server.dispatch", run.data.get("t0"), run.data.get("blocks", 0))
