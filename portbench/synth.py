"""The benchmark's synthetic array: a frozen copy of the port's synthesizer,
and the periodic stream that the server cells replay.

Frozen copy of ``coherent_rtlsdr_tpu_torch/signal/synth.py`` (``make_truth``,
``quantize_u8``, ``_cnormal``, ``_seeded``, ``_ref_block``,
``synth_stream_slab``) and of ``coherent_rtlsdr_tpu_torch/ops/delay.py``
(``iramp_fraction``, ``delay_ramp``, ``_farrow_coeffs``,
``farrow_fractional_delay``) at commit eccdfa5.
``tests/test_portbench_copies.py`` holds each copy equal to the original.

Receiver ``i`` sees ``gain_i * exp(j*phase_i) * ref(t - delay_i - skew_i(t))
+ noise_i`` with ``skew_i(t) = ppm_i * 1e-6 * t`` (residual clock-rate
offset, applied by the Farrow interpolator), quantized to 8-bit offset
binary (the RTL2832 ADC path).

``render_periodic`` is the benchmark's own: one period of P blocks of a
periodic stream. The reference noise of the whole period is drawn at once,
each channel is delayed circularly over the period (exact for a periodic
signal), and the receiver noise of the period is drawn at once. Block g of
the endless stream is block g mod P of the period, and the boundary between
block P - 1 and block 0 is as continuous as any other. A periodic stream
holds its delays fixed, so it renders no clock skew.
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChannelTruth:
    delays: np.ndarray  # [N] samples (positive = channel lags the reference)
    phases: np.ndarray  # [N] radians
    gains: np.ndarray   # [N] linear
    ppm: np.ndarray     # [N] parts-per-million residual clock skew
    snr_db: float


def make_truth(n_channels: int, seed: int = 0, max_delay: float = 40.0,
               snr_db: float = 30.0, max_ppm: float = 0.0) -> ChannelTruth:
    rng = np.random.default_rng(seed)
    return ChannelTruth(
        delays=rng.uniform(-max_delay, max_delay, n_channels).astype(np.float32),
        phases=rng.uniform(-np.pi, np.pi, n_channels).astype(np.float32),
        gains=rng.uniform(0.7, 1.0, n_channels).astype(np.float32),
        ppm=rng.uniform(-max_ppm, max_ppm, n_channels).astype(np.float32),
        snr_db=snr_db,
    )


def quantize_u8(x: torch.Tensor, scale: float = 127.0) -> torch.Tensor:
    """complex64 [..., L] -> offset-binary uint8 [..., L, 2] (ADC model)."""
    iq = torch.stack([x.real, x.imag], dim=-1) * scale
    return (torch.clamp(torch.round(iq), -128.0, 127.0) + 128.0).to(torch.uint8)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _cnormal(shape, gen: torch.Generator, device) -> torch.Tensor:
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return torch.complex(re, im)


def iramp_fraction(k: torch.Tensor, d_int: torch.Tensor, W: int) -> torch.Tensor:
    """Exact phase fraction ``(k * d) mod W / W`` of integer delays."""
    dm = torch.remainder(d_int.to(torch.int64), W)
    dm = dm.reshape(*dm.shape, *([1] * k.dim()))
    return torch.remainder(k * dm, W).to(torch.float32) / W


def delay_ramp(fft_len: int, delay: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """Spectrum multiplier implementing ``x[n] -> x[n - delay]``, ``[..., fft_len]``."""
    if fft_len & (fft_len - 1):
        raise ValueError("delay_ramp requires a power-of-two fft_len")
    d = torch.as_tensor(delay, dtype=torch.float32)
    d_int = torch.floor(d)
    d_frac = (d - d_int)[..., None]
    f = torch.fft.fftfreq(fft_len, dtype=torch.float32, device=d.device)
    k = torch.arange(fft_len, dtype=torch.int64, device=d.device)
    phase = iramp_fraction(k, d_int, fft_len) + f * d_frac
    theta = -2.0 * torch.pi * phase
    return torch.polar(torch.ones_like(theta), theta).to(dtype)


def _farrow_coeffs(mu: torch.Tensor):
    """Cubic Lagrange basis at ``mu`` in [0, 1) between taps x[n] and
    x[n+1], over the taps x[n-1], x[n], x[n+1], x[n+2]."""
    m = torch.as_tensor(mu, dtype=torch.float32)
    c_m1 = -m * (m - 1.0) * (m - 2.0) / 6.0
    c_0 = (m + 1.0) * (m - 1.0) * (m - 2.0) / 2.0
    c_p1 = -(m + 1.0) * m * (m - 2.0) / 2.0
    c_p2 = (m + 1.0) * m * (m - 1.0) / 6.0
    return c_m1, c_0, c_p1, c_p2


def farrow_fractional_delay(x: torch.Tensor, advance) -> torch.Tensor:
    """``x(n + advance)`` by a 4-tap cubic-Lagrange Farrow FIR; indices wrap
    circularly."""
    T = x.shape[-1]
    a = torch.as_tensor(advance, dtype=torch.float32, device=x.device)
    if a.dim() == x.dim() - 1 and a.dim() > 0:
        a = a[..., None]
    pos = torch.arange(T, dtype=torch.float32, device=x.device) + a
    n0 = torch.floor(pos)
    mu = (pos - n0).expand(x.shape)
    n0 = n0.to(torch.int64).expand(x.shape)
    taps = [torch.gather(x, -1, torch.remainder(n0 + k, T)) for k in (-1, 0, 1, 2)]
    return sum(t * c.to(x.dtype) for t, c in zip(taps, _farrow_coeffs(mu)))


def _seeded(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key`` through
    numpy's SeedSequence."""
    ss = np.random.SeedSequence([k % 2**64 for k in key])
    return torch.Generator(device=device).manual_seed(int(ss.generate_state(1, np.uint64)[0]))


def _ref_block(seed: int, g: int, L: int, amplitude: float, device) -> torch.Tensor:
    return _cnormal((L,), _seeded(device, seed, 0x5EED, g), device) * amplitude


def _rotation(truth: ChannelTruth, dev) -> torch.Tensor:
    return torch.from_numpy(truth.gains * np.exp(1j * truth.phases)).to(dev, torch.complex64)


def _noise_amp(truth: ChannelTruth, amplitude: float) -> float:
    return amplitude / np.sqrt(10.0 ** (truth.snr_db / 10.0))


def synth_stream_slab(seed: int, truth: ChannelTruth, slab_idx: int, slab_blocks: int,
                      block_len: int = 8192, amplitude: float = 0.25, device="cuda"):
    """One slab of a continuous synthetic stream: ``(sig_u8 [S, N, L, 2],
    ref_u8 [S, L, 2])`` uint8 on ``device``. The channels are delayed and
    skewed over the slab with one margin block before it, the skew's advance
    in absolute stream time."""
    dev = torch.device(device)
    N = len(truth.delays)
    S, L = slab_blocks, block_len
    if np.max(np.abs(truth.delays)) + 8 > L:
        raise ValueError("synth_stream_slab needs max|delay| + 8 <= block_len")
    g0 = slab_idx * S
    E = _next_pow2(S + 2)
    ref_ext = torch.cat([_ref_block(seed, g, L, amplitude, dev)
                         for g in range(g0 - 1, g0 - 1 + E)])
    W = ref_ext.shape[0]
    delays = torch.from_numpy(truth.delays).to(dev)
    delayed = torch.fft.ifft(torch.fft.fft(ref_ext)[None, :] * delay_ramp(W, delays), dim=-1)
    if np.any(truth.ppm != 0.0):
        t_abs = (g0 - 1) * L + torch.arange(W, dtype=torch.float32, device=dev)
        adv = -torch.from_numpy(truth.ppm).to(dev)[:, None] * 1e-6 * t_abs[None, :]
        delayed = farrow_fractional_delay(delayed, adv)
    noise = (_cnormal((N, S * L), _seeded(dev, seed, 0xA0A0 + slab_idx), dev)
             * _noise_amp(truth, amplitude))
    interior = delayed[:, L: (S + 1) * L] * _rotation(truth, dev)[:, None] + noise
    ref_u8 = quantize_u8(ref_ext[L: (S + 1) * L].reshape(S, L))
    sig_u8 = quantize_u8(interior.reshape(N, S, L).transpose(0, 1))
    return sig_u8, ref_u8


def periodic_delay(ref: torch.Tensor, delays: torch.Tensor) -> torch.Tensor:
    """``ref`` [P*L] complex delayed circularly by each of ``delays`` [N]:
    ``[N, P*L]``, the exact delay of the periodic signal."""
    W = ref.shape[-1]
    return torch.fft.ifft(torch.fft.fft(ref)[None, :] * delay_ramp(W, delays), dim=-1)


def render_periodic(seed: int, truth: ChannelTruth, period_blocks: int, block_len: int,
                    amplitude: float = 0.25, device="cuda"):
    """One period of the periodic stream: ``(sig_u8 [P, N, L, 2], ref_u8
    [P, L, 2])`` uint8 on ``device``, from four large draws and two
    transforms over the period."""
    dev = torch.device(device)
    if np.any(truth.ppm != 0.0):
        raise ValueError("the periodic stream renders ppm 0 only")
    N, P, L = len(truth.delays), period_blocks, block_len
    if np.max(np.abs(truth.delays)) + 8 > L:
        raise ValueError("render_periodic needs max|delay| + 8 <= block_len")
    ref = _cnormal((P * L,), _seeded(dev, seed, 0x5EED), dev) * amplitude
    sig = periodic_delay(ref, torch.from_numpy(truth.delays).to(dev))
    sig = sig * _rotation(truth, dev)[:, None]
    sig += _cnormal((N, P * L), _seeded(dev, seed, 0xA0A0), dev) * _noise_amp(truth, amplitude)
    sig_u8 = quantize_u8(sig.reshape(N, P, L).transpose(0, 1))
    return sig_u8, quantize_u8(ref.reshape(P, L))
