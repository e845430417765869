"""Synthetic multichannel capture with ground truth."""

from coherent_rtlsdr_tpu_torch.signal.synth import (
    ChannelTruth,
    SynthCapture,
    make_truth,
    quantize_u8,
    synth_capture,
)

__all__ = ["ChannelTruth", "SynthCapture", "make_truth", "quantize_u8", "synth_capture"]
