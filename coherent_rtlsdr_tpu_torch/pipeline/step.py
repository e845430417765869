"""The per-block streaming step (port of
``coherent_rtlsdr_tpu/pipeline/step.py``: ``_seq_gap``, the generic body of
``step`` and ``_step_fused_u8``).

Generic path (fft_impl "xla", "mxu", "pallas", "auto"), through the spectral
backend of ``kernels/backend.py``:

    u8 -> complex -> window spectra (history block + this block)
       -> measure -> control law -> fractional advance (overlap-save centre)
       -> phase estimate on the aligned block -> phase EMA -> aligned complex

Fused path (fft_impl "fused"), raw u8 bytes in, int8 wire bytes out:

    XOR 0x80 -> measure kernel -> control law -> phase EMA -> apply kernel

where the phase estimate is arg(z) of the measure kernel's correlation
value (Parseval inner product at the measured lag) and the phase correction
is folded into the apply kernel's frequency-domain ramp.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch.constants import IQ_SCALE
from coherent_rtlsdr_tpu_torch.kernels.backend import get_spectral
from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
from coherent_rtlsdr_tpu_torch.ops.convert import c2f, f2c, u8_to_c64, u8_to_i8
from coherent_rtlsdr_tpu_torch.ops.phase import (
    ema_complex,
    phase_correction_estimate,
    unit_phasor,
)
from coherent_rtlsdr_tpu_torch.ops.spectral import rms
from coherent_rtlsdr_tpu_torch.pipeline.control import control_update
from coherent_rtlsdr_tpu_torch.pipeline.state import (
    SEQ_MASK,
    BlockOutput,
    PipelineConfig,
    PipelineState,
    Telemetry,
    fused_m,
)


def as_seq(seq, device) -> torch.Tensor:
    """Capture seqnums (uint32 values from numpy, Python or torch) as the
    port's int64 carrier, masked to 32 bits."""
    if isinstance(seq, torch.Tensor):
        seq = seq.to(device=device, dtype=torch.int64)
    else:
        seq = torch.from_numpy(np.asarray(seq).astype(np.int64)).to(device)
    return seq & SEQ_MASK


def _seq_gap(state: PipelineState, seq, update_gate):
    """Seqnum-gap detection: returns (seq, gap, new_gaps, meas_ok). A channel
    whose seqnum did not advance by exactly one (modulo 2^32) since the last
    block has a gap, unless this is the first block."""
    if seq is None:
        seq = (state.last_seq + 1) & SEQ_MASK
    else:
        seq = as_seq(seq, state.last_seq.device)
    delta = (seq - state.last_seq) & SEQ_MASK
    gap = (delta != 1) & (state.block_idx > 0)
    new_gaps = state.gaps + gap.to(torch.int32)
    meas_ok = update_gate & ~gap
    return seq, gap, new_gaps, meas_ok


def step(
    cfg: PipelineConfig,
    state: PipelineState,
    sig_u8: torch.Tensor,   # [N, L, 2] or flat [N, 2L] uint8 raw interleaved IQ
    ref_u8: torch.Tensor,   # [L, 2] or flat [2L] uint8 reference IQ
    update_gate,            # bool or bool tensor: reference noise injected
    seq: Optional[torch.Tensor] = None,  # [N] uint32 capture seqnums
) -> Tuple[PipelineState, BlockOutput]:
    """Process one block: measure -> control -> phase -> correct -> emit.

    Output samples carry a fixed latency of L/2 samples (the overlap-save
    centre window). ``seq`` enables gap detection: a channel whose seqnum
    jumps has its measurement ignored this block, its phase frozen, its sync
    flag dropped and its gap count bumped. ``seq=None`` means contiguous.
    """
    if cfg.fft_impl == "fused":
        return _step_fused_u8(cfg, state, sig_u8, ref_u8, update_gate, seq)

    N, L = cfg.n_channels, cfg.block_len
    dev = state.delay.device
    gate = torch.as_tensor(update_gate, dtype=torch.bool, device=dev)
    sig = u8_to_c64(sig_u8.reshape(N, L, 2))   # [N, L]
    ref = u8_to_c64(ref_u8.reshape(L, 2))      # [L]
    seq, gap, new_gaps, meas_ok = _seq_gap(state, seq, gate)
    sp = get_spectral(cfg, 2 * L, dev)

    # One preparation pass feeds both measurement and correction; the
    # window of this step is (history, current).
    ref_prev = f2c(state.ref_hist)
    ctx = sp.prepare(torch.stack([f2c(state.hist), sig]), torch.stack([ref_prev, ref]))
    meas = sp.measure(ctx, cfg.lag_method)
    lag, mag, papr = meas.lag[0], meas.mag[0], meas.papr[0]

    new_delay, new_synced = control_update(cfg, state.delay, state.synced, lag, mag, meas_ok)
    new_synced = new_synced & ~gap

    out_raw = sp.correct(ctx, new_delay[None])[0]                    # [N, L] aligned
    out_ref = torch.cat([ref_prev[L // 2:], ref[: L // 2]])          # [L] same latency

    # Phase estimate on the time-aligned signal, gated by the reference
    # noise flag and by measurement quality.
    pc_inst = phase_correction_estimate(out_raw, out_ref)
    good = meas_ok & (mag >= cfg.min_corr_mag)
    old_phase = f2c(state.phase)
    new_phase = torch.where(good, ema_complex(old_phase, pc_inst, alpha=cfg.phase_alpha),
                            old_phase)

    phase_f = c2f(new_phase)
    telemetry = Telemetry(
        lag=lag, residual=lag - new_delay, mag=mag, papr=papr, phase=phase_f,
        synced=new_synced, rms=rms(sig, dim=-1), gap=gap, gaps=new_gaps,
    )
    new_state = PipelineState(
        delay=new_delay, phase=phase_f, lag=lag, mag=mag, papr=papr, synced=new_synced,
        hist=c2f(sig), ref_hist=c2f(ref), block_idx=state.block_idx + 1,
        last_seq=seq, gaps=new_gaps,
    )
    return new_state, BlockOutput(telemetry=telemetry,
                                  aligned_c64=out_raw * new_phase[:, None], ref_c64=out_ref)


def _step_fused_u8(cfg, state, sig_u8, ref_u8, update_gate, seq=None):
    if cfg.lag_method not in ("phase_zoom", "auto"):
        raise ValueError(
            "fft_impl='fused' computes lag in-kernel with the phase_zoom "
            f"estimator; set lag_method='phase_zoom' (got '{cfg.lag_method}')")
    N, L = cfg.n_channels, cfg.block_len
    m = fused_m(cfg)
    dev = state.delay.device
    k = get_fused_kernels(2 * L, dev)
    gate = torch.as_tensor(update_gate, dtype=torch.bool, device=dev)

    seq, gap, new_gaps, meas_ok = _seq_gap(state, seq, gate)

    raw_cur = u8_to_i8(sig_u8.reshape(N, m // 2, 2 * m))
    ref_cur = u8_to_i8(ref_u8.reshape(m // 2, 2 * m))
    raw = torch.stack([state.hist, raw_cur])           # [2, N, m/2, 2m]
    ref_raw = torch.stack([state.ref_hist, ref_cur])   # [2, m/2, 2m]

    lag_b, zre_b, zim_b, mag_b, papr_b, dre_b, dim_b = k.measure_i8_spec(raw, ref_raw)
    lag, zre, zim, mag, papr = lag_b[0], zre_b[0], zim_b[0], mag_b[0], papr_b[0]

    new_delay, new_synced = control_update(cfg, state.delay, state.synced, lag, mag, meas_ok)
    new_synced = new_synced & ~gap

    # pc_inst = conj(z)/|z|, the phase_correction_estimate convention.
    pc_inst = unit_phasor(torch.complex(zre, -zim))
    good = meas_ok & (mag >= cfg.min_corr_mag)
    old_phase = f2c(state.phase)
    new_phase = torch.where(good, ema_complex(old_phase, pc_inst, alpha=cfg.phase_alpha),
                            old_phase)

    wire = k.apply_spec_i8(dre_b, dim_b, new_delay[None],
                           new_phase.real[None].contiguous(),
                           new_phase.imag[None].contiguous())[0].reshape(N, 2 * L)
    # Reference channel: raw passthrough at the same latency (half a block
    # = m/4 rows), never requantized.
    wire_ref = torch.cat([state.ref_hist[m // 4:], ref_cur[: m // 4]], dim=0).reshape(2 * L)

    # Block RMS from the raw bytes: mean(I^2+Q^2) = 2 mean(byte^2).
    f = raw_cur.to(torch.float32)
    rms_val = torch.sqrt(2.0 * torch.mean(f * f, dim=(-2, -1))) * IQ_SCALE

    phase_f = c2f(new_phase)
    telemetry = Telemetry(
        lag=lag, residual=lag - new_delay, mag=mag, papr=papr, phase=phase_f,
        synced=new_synced, rms=rms_val, gap=gap, gaps=new_gaps,
    )
    new_state = PipelineState(
        delay=new_delay, phase=phase_f, lag=lag, mag=mag, papr=papr, synced=new_synced,
        hist=raw_cur, ref_hist=ref_cur, block_idx=state.block_idx + 1,
        last_seq=seq, gaps=new_gaps,
    )
    return new_state, BlockOutput(telemetry=telemetry, wire=wire, wire_ref=wire_ref)
