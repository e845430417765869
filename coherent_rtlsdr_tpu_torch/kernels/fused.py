"""The fused measure/apply kernels (port of
``coherent_rtlsdr_tpu/kernels/pallas_fused.py``).

    measure:  window --FFT--> D --x conj(R)--> G --phase-zoom--> (lag, z, ...)
    apply:    D --x ramp(delay) [x phase]--> --IFFT--> centre half

The overlap-save window of output slot t is stream blocks (t, t+1), W = 2L
= m*m, and spectra are in the permuted (k2, k1) layout of
``kernels/fft4step.py``. Two block formats:

* i8: signed capture bytes in the wide layout ``[..., m/2, 2m]`` (row r
  holds samples [r*m, (r+1)*m) as I0 Q0 I1 Q1 ...), int8 wire bytes out,
  as two pairs. ``measure_ref`` transforms the reference windows once for
  either (on the TPU one kernel body did that too, carrying the reference
  spectrum across the channels of a grid step).
  - The spectrum handoff (the fused pipeline's pair): ``measure_spec``
    measures every channel window against the reference and stores D as
    bf16; ``apply_spec_i8`` turns D into wire bytes.
  - The recompute pair (the JAX package's baseline for the handoff):
    ``measure_i8`` returns the same five scalars and stores nothing;
    ``apply_i8`` reads the bytes again and recomputes the forward transform,
    ramping the float32 D.
* float (``FusedSpectral``): bf16 block planes ``[T, N, m/2, m]`` (re, im).
  ``measure`` takes the reference window spectra as bf16 planes and returns
  (lag, |z|, sum |D|^2, sum |G|^2); ``apply`` recomputes the forward
  transform and returns the float32 centre half, with no phase factor.

Each operation has a plain PyTorch version here (``*_plain``) and a CUDA
kernel written by hand (``csrc/fused_measure.cu``, ``csrc/fused_apply.cu``,
bound in ``kernels/fused_cuda.py``), and dispatches on the device of its
input: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel (or raises). The instance counts the runs of each (``COUNTS``).
When ``utils.SPANS`` is recording, each dispatch is the host span
``kernels.<operation>``: on the card, the ``fused_cuda`` wrapper's checks,
allocations and ctypes launch; on the CPU, the whole plain version.
The kernels take m in {64, 128, 256}; at m = 256 (L = 32768) each runs a
window on a cluster of four CTAs (``csrc/fused_cluster.cuh``), one launch
a call as at the smaller sizes (``fused_cuda.ADMITTED_M``). The plain
versions take any square m with m % 8 == 0.

The plain versions reproduce the JAX kernels' bf16 casts exactly: each
product takes bf16-rounded operands and accumulates in float32, cast at the
points where the JAX kernel casts. The JAX kernels' 0/1 selection matmuls
(de-interleave, re-interleave, band sums) are slicing and sums here, and its
polynomial arctangent is ``torch.atan2``.
"""

import functools
import math

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch.constants import IQ_SCALE
from coherent_rtlsdr_tpu_torch.kernels.fft4step import (
    FFT4Step,
    bf16_round,
    cmatmul,
    exact_f32_matmul,
)
from coherent_rtlsdr_tpu_torch.ops.delay import iramp_fraction
from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS

_TWO_PI = 2.0 * math.pi

# The operations with a CUDA kernel each; the instance counts the launches
# of each kernel ("<name>_launches") and the runs of each plain version
# ("<name>_plain_runs").
KERNELS = ("measure_ref", "measure_spec", "apply_spec_i8", "measure_i8", "apply_i8",
           "measure", "apply")
COUNTS = tuple(f"{k}_launches" for k in KERNELS) + tuple(f"{k}_plain_runs" for k in KERNELS)


# The m whose kernels run a window on a cluster of four CTAs and take F and
# Fi as packed k-slices (``cluster_slices``).
CLUSTER_M = 256
SLICE_K = 16


def cluster_slices(fft: FFT4Step):
    """F and Fi = conj(F)/m of a bf16 ``FFT4Step`` as the m = 256 cluster
    kernels stream them (``csrc/fused_cluster.cuh``): bf16 ``[m/16 (slice),
    2 (re, im), m/8, 2, 8, 8]``, slice s holding rows n and columns k in
    [16 s, 16 s + 16) of each plane in 8 x 8 core matrices, (n // 8, k % 16
    // 8) in that order, each row n % 8 of 8 contiguous k. The values are the
    bf16-rounded tables, unchanged."""
    m = fft.m

    def slices(re, im):
        planes = torch.stack([re, im]).to(torch.bfloat16)           # [2, n, k]
        x = planes.reshape(2, m // 8, 8, m // SLICE_K, 2, 8)         # pl, G, n8, s, h, k8
        return x.permute(3, 0, 1, 4, 2, 5).contiguous()              # s, pl, G, h, n8, k8

    return slices(fft.fre, fft.fim), slices(fft.fire, fft.fiim)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cmul_conj(ar, ai, br, bi):
    """(ar + i ai) * conj(br + i bi)."""
    return ar * br + ai * bi, ai * br - ar * bi


class FusedPipelineKernels:
    """The measure/apply kernels for one ``fft_len = m*m`` on one device."""

    def __init__(self, fft_len: int, device="cuda"):
        m = int(round(np.sqrt(fft_len)))
        if m * m != fft_len or m % 8:
            raise ValueError(f"fft_len {fft_len} unsupported (need square, m%8==0)")
        self.fft_len = fft_len
        self.m = m
        self.device = torch.device(device)
        # The four-step tables: F and conj(F)/m bf16-rounded (the JAX kernel
        # casts them to bf16), the twiddle float32.
        self.fft = FFT4Step(fft_len, self.device)
        # At m = 256 the kernels take F and Fi as packed k-slices, built once.
        self.f_slices, self.fi_slices = (cluster_slices(self.fft) if m == CLUSTER_M
                                         else (None, None))
        self.kg = self.fft.freq_index_grid().to(torch.int64)
        self.fg = self.fft.signed_freq_grid()
        self.reset_counts()

    def reset_counts(self):
        """Zero the run counts: one per CUDA kernel, counted by its wrapper
        in ``fused_cuda`` right after it launches, and one per plain
        version."""
        for name in COUNTS:
            setattr(self, name, 0)

    def counts(self) -> dict:
        return {name: getattr(self, name) for name in COUNTS}

    # -- dispatch -------------------------------------------------------
    def measure_ref(self, ref_raw: torch.Tensor):
        """ref_raw ``[T, m/2, 2m]`` int8 reference blocks. Returns the
        reference window spectra R as float32 ``[T-1, m, m, 2]`` (re, im)
        and their energies eref = sum |R|^2, float32 ``[T-1]``."""
        with SPANS.span("kernels.measure_ref"):
            if ref_raw.is_cuda:
                from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

                return fused_cuda.measure_ref(self, ref_raw)
            if ref_raw.device.type == "cpu":
                return self.measure_ref_plain(ref_raw)
            raise ValueError(f"no measure_ref for device {ref_raw.device}")

    def measure_spec(self, raw: torch.Tensor, R: torch.Tensor, eref: torch.Tensor):
        """raw ``[T, N, m/2, 2m]`` int8 channel blocks against the
        reference spectra of :meth:`measure_ref`. Returns (lag, z_re, z_im,
        mag, papr), each float32 ``[T-1, N]``, and (dre, dim), the permuted
        window spectra as bf16 ``[T-1, N, m, m]``."""
        with SPANS.span("kernels.measure_spec"):
            if raw.is_cuda:
                from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

                return fused_cuda.measure_spec(self, raw, R, eref)
            if raw.device.type == "cpu":
                return self.measure_spec_plain(raw, R, eref)
            raise ValueError(f"no measure_spec for device {raw.device}")

    def measure_i8_spec(self, raw: torch.Tensor, ref_raw: torch.Tensor):
        """:meth:`measure_spec` of ``raw`` against :meth:`measure_ref` of
        ``ref_raw`` (the TPU kernel did both in one body)."""
        return self.measure_spec(raw, *self.measure_ref(ref_raw))

    def apply_spec_i8(self, dre, dim, advance, phase_re, phase_im):
        """Consumes measure_i8_spec's bf16 spectra ``[T-1, N, m, m]`` and
        float32 advance / phase factor ``[T-1, N]``. Returns the phase- and
        delay-corrected overlap-save centre half as int8 wire blocks ``[T-1,
        N, m/2, 2m]`` (byte-identical to the ``[L, 2]`` wire layout)."""
        with SPANS.span("kernels.apply_spec_i8"):
            if dre.is_cuda:
                from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

                return fused_cuda.apply_spec_i8(self, dre, dim, advance, phase_re, phase_im)
            if dre.device.type == "cpu":
                return self.apply_spec_i8_plain(dre, dim, advance, phase_re, phase_im)
            raise ValueError(f"no apply_spec_i8 for device {dre.device}")

    def measure_i8(self, raw: torch.Tensor, ref_raw: torch.Tensor):
        """The recompute pair's measure: raw ``[T, N, m/2, 2m]`` int8
        channel blocks against :meth:`measure_ref` of ``ref_raw`` ``[T, m/2,
        2m]`` (two kernels, as :meth:`measure_i8_spec`). Returns (lag, z_re,
        z_im, mag, papr), each float32 ``[T-1, N]``, the scalars of
        :meth:`measure_spec`, and stores no spectrum."""
        R, eref = self.measure_ref(ref_raw)
        with SPANS.span("kernels.measure_i8"):
            if raw.is_cuda:
                from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

                return fused_cuda.measure_i8(self, raw, R, eref)
            if raw.device.type == "cpu":
                return self.measure_i8_plain(raw, R, eref)
            raise ValueError(f"no measure_i8 for device {raw.device}")

    def apply_i8(self, raw: torch.Tensor, advance, phase_re, phase_im):
        """The recompute pair's apply: raw ``[T, N, m/2, 2m]`` int8 blocks
        and float32 advance / phase factor ``[T-1, N]``. Recomputes the
        window spectra and returns the wire blocks of :meth:`apply_spec_i8`
        from the float32 spectra, int8 ``[T-1, N, m/2, 2m]``."""
        with SPANS.span("kernels.apply_i8"):
            if raw.is_cuda:
                from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

                return fused_cuda.apply_i8(self, raw, advance, phase_re, phase_im)
            if raw.device.type == "cpu":
                return self.apply_i8_plain(raw, advance, phase_re, phase_im)
            raise ValueError(f"no apply_i8 for device {raw.device}")

    def measure(self, pre, pim, rre, rim):
        """Float path: block planes ``pre``/``pim`` bf16 ``[T, N, m/2, m]``
        against the reference window spectra ``rre``/``rim`` bf16 ``[T-1,
        m, m]``. Returns (lag, |z|, sum |D|^2, sum |G|^2), each float32
        ``[T-1, N]``."""
        with SPANS.span("kernels.measure"):
            if pre.is_cuda:
                from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

                return fused_cuda.measure_planes(self, pre, pim, rre, rim)
            if pre.device.type == "cpu":
                return self.measure_plain(pre, pim, rre, rim)
            raise ValueError(f"no measure for device {pre.device}")

    def apply(self, pre, pim, advance):
        """Float path: block planes ``pre``/``pim`` bf16 ``[T, N, m/2, m]``
        and advance float32 ``[T-1, N]``. Returns the delay-corrected
        overlap-save centre half (yre, yim), each float32 ``[T-1, N, W/2]``."""
        with SPANS.span("kernels.apply"):
            if pre.is_cuda:
                from coherent_rtlsdr_tpu_torch.kernels import fused_cuda

                return fused_cuda.apply_planes(self, pre, pim, advance)
            if pre.device.type == "cpu":
                return self.apply_plain(pre, pim, advance)
            raise ValueError(f"no apply for device {pre.device}")

    # -- plain versions ---------------------------------------------------
    def _window_planes(self, pre, pim):
        """bf16 block planes ``[T, ..., m/2, m]`` -> the float32 (re, im)
        windows ``[T-1, ..., m, m]`` of blocks (t, t+1)."""
        cat = lambda p: torch.cat([p[:-1], p[1:]], dim=-2).to(torch.float32)
        return cat(pre), cat(pim)

    def _windows(self, raw):
        """Dequantize (``_dq_i8``) and de-interleave ``[T, ..., m/2, 2m]``
        int8 blocks into the (re, im) windows ``[T-1, ..., m, m]`` of blocks
        (t, t+1)."""
        a = bf16_round(raw.to(torch.float32) * IQ_SCALE)
        re, im = a[..., 0::2], a[..., 1::2]
        return (torch.cat([re[:-1], re[1:]], dim=-2),
                torch.cat([im[:-1], im[1:]], dim=-2))

    def _phase_zoom(self, gre, gim):
        """The two-stage banded phase-slope estimator on permuted
        cross-spectra ``[..., m, m]`` (``_phase_zoom_core``). Returns (lag,
        z_re, z_im, sum|G|^2), each ``[...]``."""
        m, W = self.m, self.fft_len
        lead = gre.shape[:-2]
        # Stage 1: 8-bin bands are row groups of 8 within a column; band
        # index b = k1*(m/8) + j. Adjacent-band products stay in a column
        # except at the j-wrap (m/8-1, k1) -> (0, k1+1); the Nyquist
        # straddle is the column boundary k1 = m/2 - 1.
        g1re = gre.reshape(*lead, m // 8, 8, m).sum(-2)
        g1im = gim.reshape(*lead, m // 8, 8, m).sum(-2)
        in_re, in_im = _cmul_conj(g1re[..., 1:, :], g1im[..., 1:, :],
                                  g1re[..., :-1, :], g1im[..., :-1, :])
        bd_re, bd_im = _cmul_conj(g1re[..., 0, 1:], g1im[..., 0, 1:],
                                  g1re[..., -1, :-1], g1im[..., -1, :-1])
        nyq = torch.ones(m - 1, device=gre.device)
        nyq[m // 2 - 1] = 0.0
        s1re = in_re.sum((-2, -1)) + (bd_re * nyq).sum(-1)
        s1im = in_im.sum((-2, -1)) + (bd_im * nyq).sum(-1)
        d1 = -torch.atan2(s1im, s1re) * ((W // 8) / _TWO_PI)
        int_lag = torch.round(d1)

        # Stage 2: deramp by the integer lag; 2m-bin bands are column pairs.
        ph = iramp_fraction(self.kg, -int_lag, W) * _TWO_PI
        gcre, gcim = _cmul(gre, gim, torch.cos(ph), -torch.sin(ph))
        M2 = m // 2
        g2re = gcre.sum(-2).reshape(*lead, M2, 2).sum(-1)
        g2im = gcim.sum(-2).reshape(*lead, M2, 2).sum(-1)
        p2re, p2im = _cmul_conj(g2re[..., 1:], g2im[..., 1:],
                                g2re[..., :-1], g2im[..., :-1])
        nyq2 = torch.ones(M2 - 1, device=gre.device)
        nyq2[M2 // 2 - 1] = 0.0
        s2re = (p2re * nyq2).sum(-1)
        s2im = (p2im * nyq2).sum(-1)
        frac = torch.clamp(-torch.atan2(s2im, s2re) * (M2 / _TWO_PI), -4.0, 4.0)

        # Correlation value at the fractional lag (Parseval: <y, ref> = z/W).
        phf = (_TWO_PI * frac)[..., None, None] * self.fg
        zre, zim = _cmul(gcre, gcim, torch.cos(phf), torch.sin(phf))
        eg = (gre * gre + gim * gim).sum((-2, -1))
        return int_lag + frac, zre.sum((-2, -1)), zim.sum((-2, -1)), eg

    def _ramp(self, advance):
        """The fractional-advance ramp for delay d = -advance,
        exp(-2 pi i (iramp(floor(d)) + f frac(d))), as (re, im) ``[...,
        m, m]``."""
        d = -advance
        di = torch.floor(d)
        df = d - di
        ph = (iramp_fraction(self.kg, di, self.fft_len)
              + self.fg * df[..., None, None]) * _TWO_PI
        return torch.cos(ph), -torch.sin(ph)

    def _inverse_centre(self, gre, gim):
        """Inverse four-step of permuted spectra, output rows m/4..3m/4
        only: time samples W/4..3W/4, the overlap-save centre half."""
        t = self.fft
        m = self.m
        rows = slice(m // 4, 3 * m // 4)
        with exact_f32_matmul(gre):
            c2re, c2im = cmatmul(bf16_round(gre), bf16_round(gim), t.fire, t.fiim)
            b2re, b2im = _cmul_conj(c2re, c2im, t.tre, t.tim)
            return cmatmul(t.fire[rows], t.fiim[rows], bf16_round(b2re), bf16_round(b2im))

    def measure_ref_plain(self, ref_raw: torch.Tensor):
        """Plain PyTorch version of :meth:`measure_ref`, on the device of its
        input."""
        self.measure_ref_plain_runs += 1
        rre, rim = self.fft.fft_planes(*self._windows(ref_raw))     # [T-1, m, m]
        return torch.stack([rre, rim], dim=-1), (rre * rre + rim * rim).sum((-2, -1))

    def _measure_channels(self, raw, R, eref):
        """The channel half of both i8 measures: (lag, z_re, z_im, mag,
        papr) ``[T-1, N]`` and the float32 window spectra (dre, dim)."""
        dre, dim = self.fft.fft_planes(*self._windows(raw))         # [T-1, N, m, m]
        gre, gim = _cmul_conj(dre, dim, R[:, None, ..., 0], R[:, None, ..., 1])
        lag, z_re, z_im, eg = self._phase_zoom(gre, gim)
        esig = (dre * dre + dim * dim).sum((-2, -1))
        zabs = torch.sqrt(z_re * z_re + z_im * z_im)
        denom = torch.sqrt(esig * eref[:, None])
        mag = zabs / torch.clamp(denom, min=1e-30)
        papr = zabs * zabs / torch.clamp(eg, min=1e-30)
        return lag, z_re, z_im, mag, papr, dre, dim

    def measure_spec_plain(self, raw: torch.Tensor, R: torch.Tensor, eref: torch.Tensor):
        """Plain PyTorch version of :meth:`measure_spec`, on the device of its
        inputs."""
        self.measure_spec_plain_runs += 1
        *scal, dre, dim = self._measure_channels(raw, R, eref)
        return (*scal, dre.to(torch.bfloat16), dim.to(torch.bfloat16))

    def measure_i8_plain(self, raw: torch.Tensor, R: torch.Tensor, eref: torch.Tensor):
        """Plain PyTorch version of :meth:`measure_i8`'s channel kernel, on
        the reference spectra of :meth:`measure_ref` (as
        :meth:`measure_spec_plain`), on the device of its inputs."""
        self.measure_i8_plain_runs += 1
        return self._measure_channels(raw, R, eref)[:5]

    def measure_i8_spec_plain(self, raw: torch.Tensor, ref_raw: torch.Tensor):
        """Plain PyTorch version of :meth:`measure_i8_spec`."""
        return self.measure_spec_plain(raw, *self.measure_ref_plain(ref_raw))

    def _apply_wire(self, dre, dim, advance, phase_re, phase_im):
        """The apply of both i8 pairs on float32 spectra: the ramp times the
        phase factor, the centre rows of the inverse, round half to even
        x127, saturate, interleave into wire blocks ``[..., m/2, 2m]``."""
        wr, wi = _cmul(*self._ramp(advance), phase_re[..., None, None], phase_im[..., None, None])
        yre, yim = self._inverse_centre(*_cmul(dre, dim, wr, wi))
        inv = 1.0 / IQ_SCALE
        yq = torch.stack([yre * inv, yim * inv], dim=-1)       # [..., m/2, m, 2]
        yq = torch.clamp(torch.round(yq), -128.0, 127.0).to(torch.int8)
        return yq.reshape(*yq.shape[:-2], 2 * self.m)

    def apply_spec_i8_plain(self, dre, dim, advance, phase_re, phase_im):
        """Plain PyTorch version of :meth:`apply_spec_i8`, on the device of
        its inputs."""
        self.apply_spec_i8_plain_runs += 1
        return self._apply_wire(dre.to(torch.float32), dim.to(torch.float32), advance,
                                phase_re, phase_im)

    def apply_i8_plain(self, raw: torch.Tensor, advance, phase_re, phase_im):
        """Plain PyTorch version of :meth:`apply_i8`, on the device of its
        inputs."""
        self.apply_i8_plain_runs += 1
        return self._apply_wire(*self.fft.fft_planes(*self._windows(raw)), advance,
                                phase_re, phase_im)

    def measure_plain(self, pre, pim, rre, rim):
        """Plain PyTorch version of :meth:`measure`, on the device of its
        inputs."""
        self.measure_plain_runs += 1
        dre, dim = self.fft.fft_planes(*self._window_planes(pre, pim))   # [T-1, N, m, m]
        gre, gim = _cmul_conj(dre, dim, rre.to(torch.float32)[:, None],
                              rim.to(torch.float32)[:, None])
        lag, z_re, z_im, eg = self._phase_zoom(gre, gim)
        return (lag, torch.sqrt(z_re * z_re + z_im * z_im),
                (dre * dre + dim * dim).sum((-2, -1)), eg)

    def apply_plain(self, pre, pim, advance):
        """Plain PyTorch version of :meth:`apply`, on the device of its
        inputs."""
        self.apply_plain_runs += 1
        dre, dim = self.fft.fft_planes(*self._window_planes(pre, pim))
        gre, gim = _cmul(dre, dim, *self._ramp(advance))
        yre, yim = self._inverse_centre(gre, gim)
        T1, N = advance.shape
        return yre.reshape(T1, N, -1), yim.reshape(T1, N, -1)


@functools.lru_cache(maxsize=None)
def _cached_kernels(fft_len: int, device: torch.device) -> FusedPipelineKernels:
    return FusedPipelineKernels(fft_len, device)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a bare "cuda" pinned to the current
    card so that one card has one cache key."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_fused_kernels(fft_len: int, device="cuda") -> FusedPipelineKernels:
    """The one :class:`FusedPipelineKernels` per (fft_len, device) of the
    process, so its launch counts cover every caller."""
    return _cached_kernels(fft_len, resolve_device(device))
