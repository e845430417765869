"""Host-side telemetry ring and block timer (copy of the JAX package's
``utils/telemetry.py``)."""

from coherent_rtlsdr_tpu_torch.utils.telemetry import BlockTimer, TelemetryRecorder

__all__ = ["TelemetryRecorder", "BlockTimer"]
