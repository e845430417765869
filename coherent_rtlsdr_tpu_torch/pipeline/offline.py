"""Offline (capture-at-rest) alignment (port of
``coherent_rtlsdr_tpu/pipeline/offline.py``): the measure -> smooth -> apply
engine.

  Phase A (parallel over T x N): window spectra, lag and quality.
  Phase B (small): smooth the measurement tracks -
            "global": quality-weighted average (constant true delays);
            "ema":    the streaming EMA law, a linear recurrence.
  Phase C (parallel over T x N): fractional advance and phase, overlap-save.

The generic path runs the phases through a spectral backend
(``kernels/backend.py``); fft_impl="fused" runs the i8 kernels, raw bytes to
wire bytes.

Under torch.profiler, or after ``utils.SPANS.enable()``, each call is the
host span ``offline.align``, tagged with the process's index of the call,
and its phases ``offline.xor`` (the u8 bytes to int8, fused path only),
``offline.measure`` (A), ``offline.smooth`` (B) and ``offline.apply`` (C).
"""

import dataclasses
import itertools
from typing import Optional

import torch

from coherent_rtlsdr_tpu_torch.kernels.backend import FusedSpectral, get_spectral
from coherent_rtlsdr_tpu_torch.ops.convert import i8_iq_to_c64, u8_to_c64, u8_to_i8
from coherent_rtlsdr_tpu_torch.ops.phase import phase_correction_estimate, unit_phasor
from coherent_rtlsdr_tpu_torch.pipeline.state import PipelineConfig, fused_m
from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS

# The index of each align_offline call in the process: its spans' request.
_calls = itertools.count()


@dataclasses.dataclass
class OfflineResult:
    """The fused path fills ``wire``/``wire_ref`` (int8 straight from the
    apply kernel), and ``aligned``/``ref`` are the complex64 reconstructions
    from those bytes (what clients receive), computed on access. The
    generic path fills ``aligned``/``ref`` as complex64 and no wire bytes."""

    lag: torch.Tensor       # [T-1, N] raw per-block lag measurements
    delay: torch.Tensor     # [T-1, N] smoothed applied advance
    mag: torch.Tensor       # [T-1, N]
    papr: torch.Tensor      # [T-1, N]
    phase: torch.Tensor     # [T-1, N] c64 applied phase factors
    wire: Optional[torch.Tensor] = None      # [T-1, N, 2L] int8 flat bytes (fused)
    wire_ref: Optional[torch.Tensor] = None  # [T-1, 2L] int8 flat bytes (fused)
    aligned_c64: Optional[torch.Tensor] = None  # [T-1, N, L] c64 (generic)
    ref_c64: Optional[torch.Tensor] = None      # [T-1, L] c64 (generic)

    @property
    def aligned(self) -> torch.Tensor:   # [T-1, N, L] c64
        if self.aligned_c64 is not None:
            return self.aligned_c64
        return i8_iq_to_c64(self.wire.reshape(*self.wire.shape[:-1], -1, 2))

    @property
    def ref(self) -> torch.Tensor:       # [T-1, L] c64
        if self.ref_c64 is not None:
            return self.ref_c64
        return i8_iq_to_c64(self.wire_ref.reshape(*self.wire_ref.shape[:-1], -1, 2))


def _ema_scan(x: torch.Tensor, alpha: float, w: torch.Tensor,
              y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated EMA along axis 0: y_t = (1 - a_t) y_{t-1} + a_t x_t with
    a_t = alpha * w_t and y_{-1} = ``y0`` (0 by default).

    The JAX package evaluates it as an associative scan; PyTorch has none,
    and the closed form through cumulative products underflows (1 - a_t is
    0.1 per accepted step at the default gain), so this is the exact
    sequential recurrence.
    """
    a = alpha * w
    A = 1.0 - a
    B = a * x
    ys = []
    y = y0
    for t in range(x.shape[0]):
        y = B[t] if y is None else A[t] * y + B[t]
        ys.append(y)
    return torch.stack(ys) if ys else B.clone()


class TimeAxis:
    """The window axis the smoothers reduce and scan along: here every
    window of the capture in one tensor. ``parallel/sharded.py`` gives the
    engine a subclass whose windows are split over the ranks of a process
    group."""

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the capture's windows (axis 0)."""
        return torch.sum(x, dim=0)

    def ema(self, x: torch.Tensor, alpha: float, w: torch.Tensor) -> torch.Tensor:
        """:func:`_ema_scan` over the capture's windows."""
        return _ema_scan(x, alpha, w)


WHOLE_CAPTURE = TimeAxis()


def smooth_delays(cfg: PipelineConfig, lag: torch.Tensor, mag: torch.Tensor,
                  smoothing: str, time: TimeAxis = WHOLE_CAPTURE) -> torch.Tensor:
    """Phase B: raw lag measurements [T', N] -> applied advances [T', N]."""
    w = (mag >= cfg.min_corr_mag).to(torch.float32)
    if smoothing == "global":
        q = w * mag * mag
        num = time.sum(q * lag)
        den = time.sum(q)
        d = num / torch.where(den > 0, den, 1.0)
        return d[None, :].expand(lag.shape)
    if smoothing == "ema":
        return time.ema(lag, cfg.ctrl_gain, w)
    raise ValueError(f"unknown smoothing: {smoothing}")


def measure_blocks(cfg: PipelineConfig, sp, ctx):
    """Phase A on the prepared windows. Returns (lag, mag, papr), each
    ``[T', N]``."""
    est = sp.measure(ctx, cfg.lag_method)
    return est.lag, est.mag, est.papr


def apply_corrections(cfg: PipelineConfig, sp, ctx, w_ref: torch.Tensor, delay: torch.Tensor,
                      mag: torch.Tensor, smoothing: str, phase_alpha: Optional[float] = None,
                      time: TimeAxis = WHOLE_CAPTURE):
    """Phase C: fractional advance and phase correction, overlap-save
    centre. ``w_ref [T', 2L]`` are the time-domain reference windows.
    Returns (aligned [T', N, L], ref [T', L], phase factors [T', N])."""
    L = cfg.block_len
    out_raw = sp.correct(ctx, delay)                     # [T', N, L]
    out_ref = w_ref[..., L // 2: L // 2 + L]             # [T', L]
    pc_inst = phase_correction_estimate(out_raw, out_ref[:, None])
    pc = _smooth_phases(cfg, pc_inst, mag, smoothing, phase_alpha, time)
    return out_raw * pc[..., None], out_ref, pc


def _smooth_phases(cfg: PipelineConfig, pc_inst: torch.Tensor, mag: torch.Tensor,
                   smoothing: str, phase_alpha: Optional[float] = None,
                   time: TimeAxis = WHOLE_CAPTURE) -> torch.Tensor:
    """Quality-gated phase smoothing of instantaneous factors [T', N] c64."""
    wgt = (mag >= cfg.min_corr_mag).to(torch.float32)
    if smoothing == "global":
        pc = unit_phasor(time.sum(pc_inst * wgt))
        return pc[None, :].expand(pc_inst.shape).to(torch.complex64)
    alpha = phase_alpha if phase_alpha is not None else cfg.phase_alpha
    z = time.ema(pc_inst, alpha, wgt.to(torch.complex64))
    zmag = torch.abs(z)
    return (z / torch.where(zmag > 0, zmag, 1.0)).to(torch.complex64)


def _align_offline_fused_i8(cfg: PipelineConfig, sp: FusedSpectral, sig_u8: torch.Tensor,
                            ref_u8: torch.Tensor, smoothing: str, time: TimeAxis) -> OfflineResult:
    """The i8-native engine: the u8 XOR is the only pass over the samples
    outside the two kernels. The phase estimate is arg(z) from the measure
    kernel, as in the streaming step."""
    k = sp._k
    m = fused_m(cfg)
    T, N = sig_u8.shape[:2]
    L = cfg.block_len
    with SPANS.span("offline.xor"):
        raw = u8_to_i8(sig_u8.reshape(T, N, m // 2, 2 * m))
        ref_raw = u8_to_i8(ref_u8.reshape(T, m // 2, 2 * m))

    with SPANS.span("offline.measure"):
        lag, zre, zim, mag, papr, dre, dim = k.measure_i8_spec(raw, ref_raw)

    with SPANS.span("offline.smooth"):
        delay = smooth_delays(cfg, lag, mag, smoothing, time)
        delay = torch.clamp(delay, -cfg.max_delay, cfg.max_delay)
        pc = _smooth_phases(cfg, unit_phasor(torch.complex(zre, -zim)), mag, smoothing,
                            time=time)

    with SPANS.span("offline.apply"):
        wire = k.apply_spec_i8(dre, dim, delay.contiguous(),
                               pc.real.contiguous(), pc.imag.contiguous())
        wire_ref = torch.cat([ref_raw[:-1, m // 4:], ref_raw[1:, : m // 4]], dim=1)
    return OfflineResult(
        lag=lag, delay=delay, mag=mag, papr=papr, phase=pc,
        wire=wire.reshape(T - 1, N, 2 * L), wire_ref=wire_ref.reshape(T - 1, 2 * L),
    )


def align_offline(cfg: PipelineConfig, sig_u8: torch.Tensor, ref_u8: torch.Tensor,
                  smoothing: str = "global", time: TimeAxis = WHOLE_CAPTURE) -> OfflineResult:
    """Align a whole capture ``sig_u8 [T, N, L, 2]`` (or flat ``[T, N, 2L]``)
    against ``ref_u8 [T, L, 2]`` (or ``[T, 2L]``) on the device of the
    bytes. Returns T-1 output blocks (block 0 seeds the overlap-save
    history, like the streaming step's first block). ``time`` is the
    smoothers' window axis: the default holds the whole capture; the
    time-sharded runner of ``parallel/sharded.py`` passes the slab of one
    rank with its reductions over the time group."""
    with SPANS.poll(), SPANS.span("offline.align", next(_calls)):
        L = cfg.block_len
        sp = get_spectral(cfg, 2 * L, sig_u8.device)
        if isinstance(sp, FusedSpectral):
            return _align_offline_fused_i8(cfg, sp, sig_u8, ref_u8, smoothing, time)

        T, N = sig_u8.shape[:2]
        with SPANS.span("offline.measure"):
            sig = u8_to_c64(sig_u8.reshape(T, N, L, 2))   # [T, N, L]
            ref = u8_to_c64(ref_u8.reshape(T, L, 2))      # [T, L]
            w_ref = torch.cat([ref[:-1], ref[1:]], dim=-1)
            ctx = sp.prepare(sig, ref)
            del sig
            lag, mag, papr = measure_blocks(cfg, sp, ctx)
        with SPANS.span("offline.smooth"):
            delay = torch.clamp(smooth_delays(cfg, lag, mag, smoothing, time),
                                -cfg.max_delay, cfg.max_delay)
        with SPANS.span("offline.apply"):
            aligned, out_ref, pc = apply_corrections(cfg, sp, ctx, w_ref, delay, mag,
                                                     smoothing, time=time)
        return OfflineResult(lag=lag, delay=delay, mag=mag, papr=papr, phase=pc,
                             aligned_c64=aligned, ref_c64=out_ref)
