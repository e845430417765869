"""Host ms an ``align_offline`` call in the traced window: the mean duration
of the ``offline.align`` spans (the call's XOR, dispatch of the two kernels
and the smoothers, from its entry to its return, while the card works on
earlier calls) that start in the window. The window's start is taken as
its end mark less its seconds, a few microseconds late, so the mean is
over the spans found rather than over ``calls``. None where the program
records no spans, or dropped some."""


def read(run):
    try:
        from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS
    except ImportError:   # a program without spans
        return None
    end, wall = dict(run.marks).get("window end"), run.data.get("wall_s")
    if end is None or wall is None:
        return None
    return SPANS.ms_per("offline.align", run.t_start + end - wall)
