"""Per-channel synchronization control law (port of
``coherent_rtlsdr_tpu/pipeline/control.py``)."""

from typing import Tuple

import torch

from coherent_rtlsdr_tpu_torch.pipeline.state import PipelineConfig


def control_update(
    cfg: PipelineConfig,
    delay: torch.Tensor,        # [N] current commanded advance
    synced: torch.Tensor,       # [N] current sync flags
    meas_lag: torch.Tensor,     # [N] measured absolute lag of the raw input
    meas_mag: torch.Tensor,     # [N] correlation coefficient of the measurement
    update_gate: torch.Tensor,  # bool, scalar or [N]: measurement usable
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(new_delay, new_synced)``:

        err   = meas_lag - delay
        step  = gain * scale * tanh(err / scale)
        delay = clip(delay + step, +-max_delay)

    applied only where the measurement passes ``update_gate`` and
    ``meas_mag >= cfg.min_corr_mag``; a channel is synced when the residual
    ``|meas_lag - new_delay| <= cfg.sync_threshold``.
    """
    err = meas_lag - delay
    step = cfg.ctrl_gain * cfg.ctrl_scale * torch.tanh(err / cfg.ctrl_scale)
    good = (meas_mag >= cfg.min_corr_mag) & update_gate
    new_delay = torch.where(good, delay + step, delay)
    new_delay = torch.clamp(new_delay, -cfg.max_delay, cfg.max_delay)
    residual = meas_lag - new_delay
    new_synced = torch.where(good, torch.abs(residual) <= cfg.sync_threshold, synced)
    return new_delay, new_synced
