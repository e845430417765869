"""The server loop's own host time a block in the traced flood window, in
ms: the self time of the ``server.block`` spans (each a loop iteration,
less its source, stage, dispatch, queue-wait and control spans), summed
over the window, over the blocks served. None where the program records
no spans, or dropped some."""


def read(run):
    try:
        from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS
    except ImportError:   # a program without spans
        return None
    return SPANS.ms_per("server.block", run.data.get("t0"), run.data.get("blocks", 0), field="self_ms")
