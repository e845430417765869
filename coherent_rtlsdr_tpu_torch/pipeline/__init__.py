"""The block pipeline over every spectral backend: state, control law,
streaming step and drivers, offline engine."""

from coherent_rtlsdr_tpu_torch.pipeline.state import (
    BlockOutput,
    PipelineConfig,
    PipelineState,
    Telemetry,
    init_state,
)
from coherent_rtlsdr_tpu_torch.pipeline.control import control_update
from coherent_rtlsdr_tpu_torch.pipeline.step import step
from coherent_rtlsdr_tpu_torch.pipeline.offline import align_offline
from coherent_rtlsdr_tpu_torch.pipeline.drivers import (
    make_packed_scan_runner,
    make_scan_runner,
    make_packed_step,
    run_capture,
)

__all__ = [
    "PipelineConfig",
    "PipelineState",
    "BlockOutput",
    "Telemetry",
    "init_state",
    "control_update",
    "step",
    "align_offline",
    "make_scan_runner",
    "make_packed_scan_runner",
    "make_packed_step",
    "run_capture",
]
