"""Host ms a block of the fused kernels' dispatch in the traced flood window:
every ``kernels.*`` span (each ``FusedPipelineKernels`` dispatch: the
wrapper's checks, allocations and ctypes launch), summed over the window,
over the blocks served. None where the program records no spans, or
dropped some."""


def read(run):
    try:
        from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS
    except ImportError:   # a program without spans
        return None
    return SPANS.ms_per("kernels.", run.data.get("t0"), run.data.get("blocks", 0))
