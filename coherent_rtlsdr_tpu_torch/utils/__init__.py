"""Host-side telemetry ring and block timer (copy of the JAX package's
``utils/telemetry.py``), and the port's host spans (``SPANS``)."""

from coherent_rtlsdr_tpu_torch.utils.telemetry import (
    SPANS,
    BlockTimer,
    SpanRecorder,
    TelemetryRecorder,
)

__all__ = ["TelemetryRecorder", "BlockTimer", "SpanRecorder", "SPANS"]
