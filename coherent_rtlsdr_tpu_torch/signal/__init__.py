"""Synthetic multichannel capture with ground truth, the continuous
synthetic stream, and the streaming server's block sources
(``signal/sources.py``)."""

from coherent_rtlsdr_tpu_torch.signal.synth import (
    ChannelTruth,
    SynthCapture,
    make_truth,
    quantize_u8,
    synth_capture,
    synth_stream_slab,
)

__all__ = ["ChannelTruth", "SynthCapture", "make_truth", "quantize_u8", "synth_capture",
           "synth_stream_slab"]
