"""Synthetic N-channel coherent capture with ground truth (port of
``coherent_rtlsdr_tpu/signal/synth.py``).

Receiver ``i`` sees ``gain_i * exp(j*phase_i) * ref(t - delay_i - skew_i(t))
+ noise_i`` with ``skew_i(t) = ppm_i * 1e-6 * t`` (residual clock-rate
offset, applied by the Farrow interpolator), quantized to 8-bit offset
binary (the RTL2832 ADC path). ``make_truth`` is the JAX package's numpy
code, so one seed gives the same truth in both; the noise comes from a
``torch.Generator`` and differs from JAX's, so the two synthesizers agree
in distribution, not in bytes.
"""

import dataclasses

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch.ops.delay import delay_ramp, farrow_fractional_delay


@dataclasses.dataclass(frozen=True)
class ChannelTruth:
    """Ground-truth channel parameters (numpy, host-side)."""

    delays: np.ndarray  # [N] samples (positive = channel lags the reference)
    phases: np.ndarray  # [N] radians
    gains: np.ndarray   # [N] linear
    ppm: np.ndarray     # [N] parts-per-million residual clock skew
    snr_db: float


@dataclasses.dataclass(frozen=True)
class SynthCapture:
    """``T`` blocks of ``N`` channels x ``L`` samples: ``ref_u8 [T, L, 2]``
    and ``sig_u8 [T, N, L, 2]`` uint8, ``ref_clean [T*L]`` complex64."""

    ref_u8: torch.Tensor
    sig_u8: torch.Tensor
    ref_clean: torch.Tensor
    truth: ChannelTruth
    block_len: int


def make_truth(
    n_channels: int,
    seed: int = 0,
    max_delay: float = 40.0,
    snr_db: float = 30.0,
    max_ppm: float = 0.0,
) -> ChannelTruth:
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


def synth_capture(
    gen: torch.Generator,
    truth: ChannelTruth,
    n_blocks: int,
    block_len: int = 8192,
    amplitude: float = 0.25,
    bandwidth: float = 1.0,
) -> SynthCapture:
    """Generate a capture with known ground truth on the generator's device.

    ``amplitude`` is the reference RMS per I/Q rail as a fraction of int8
    full scale; ``bandwidth`` < 1 lowpasses the reference noise to that
    fraction of fs.
    """
    dev = gen.device
    N = len(truth.delays)
    T, L = n_blocks, block_len
    total = T * L
    # Pad so the circular delay wrap stays outside the emitted region.
    margin = int(max(256.0, 4.0 * float(np.max(np.abs(truth.delays)) + 1.0)))
    W = _next_pow2(total + margin)

    ref = _cnormal((W,), gen, dev) * amplitude
    F_ref = torch.fft.fft(ref)
    if bandwidth < 1.0:
        f = torch.abs(torch.fft.fftfreq(W, device=dev))
        F_ref = torch.where(f <= bandwidth / 2.0, F_ref, 0)
        ref = torch.fft.ifft(F_ref) / np.sqrt(bandwidth)
        F_ref = torch.fft.fft(ref)

    # Exact per-channel fractional delays as one frequency-domain product.
    delays = torch.from_numpy(truth.delays).to(dev)
    delayed = torch.fft.ifft(F_ref[None, :] * delay_ramp(W, delays), dim=-1)[:, :total]

    # Residual clock skew: time-varying advance -ppm*1e-6*t (Farrow).
    if np.any(truth.ppm != 0.0):
        t = torch.arange(total, dtype=torch.float32, device=dev)
        adv = -torch.from_numpy(truth.ppm).to(dev)[:, None] * 1e-6 * t[None, :]
        delayed = farrow_fractional_delay(delayed, adv)

    rot = torch.from_numpy(truth.gains * np.exp(1j * truth.phases)).to(dev, torch.complex64)
    noise_amp = amplitude / np.sqrt(10.0 ** (truth.snr_db / 10.0))
    sig = delayed * rot[:, None] + _cnormal((N, total), gen, dev) * noise_amp

    ref_clean = ref[:total]
    return SynthCapture(
        ref_u8=quantize_u8(ref_clean.reshape(T, L)),
        sig_u8=quantize_u8(sig.reshape(N, T, L).transpose(0, 1)),
        ref_clean=ref_clean,
        truth=truth,
        block_len=L,
    )


def _seeded(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key`` (negative
    ones too) through numpy's SeedSequence."""
    ss = np.random.SeedSequence([k % 2**64 for k in key])
    return torch.Generator(device=device).manual_seed(int(ss.generate_state(1, np.uint64)[0]))


def _ref_block(seed: int, g: int, L: int, amplitude: float, device) -> torch.Tensor:
    """Reference noise of global block ``g``: a function of (seed, g) alone,
    so any slab of the stream renders it identically."""
    return _cnormal((L,), _seeded(device, seed, 0x5EED, g), device) * amplitude


def synth_stream_slab(
    seed: int,
    truth: ChannelTruth,
    slab_idx: int,
    slab_blocks: int,
    block_len: int = 8192,
    amplitude: float = 0.25,
    device="cuda",
):
    """One slab of a continuous synthetic stream, rendered on ``device``:
    slab ``i`` followed by slab ``i+1`` gives the same reference bytes as
    one render of both, and signal bytes within the receiver noise.

    Continuity matters because the pipeline's overlap-save windows span
    block boundaries: an independent realization per slab would put a seam
    under one window per slab. The reference noise of global block g comes
    from its own generator, seeded from (seed, g); each slab is rendered
    with one margin block before it and enough after it to make the window
    a power of two (the margin blocks are real stream content), channels are
    delayed and skewed over that window (the skew's advance in absolute
    stream time), and only the interior is emitted. Receiver noise of slab
    i is seeded from (seed, 0xA0A0 + i).

    CPU and CUDA generators draw different numbers from one seed, so a
    slab's bytes depend on ``device``: compare slabs rendered on the same
    device.

    Returns ``(sig_u8 [S, N, L, 2], ref_u8 [S, L, 2])`` uint8 on ``device``.
    """
    dev = torch.device(device)
    N = len(truth.delays)
    S, L = slab_blocks, block_len
    if np.max(np.abs(truth.delays)) + 8 > L:
        raise ValueError("synth_stream_slab needs max|delay| + 8 <= block_len")
    g0 = slab_idx * S
    E = _next_pow2(S + 2)   # global blocks [g0 - 1, g0 - 1 + E)
    ref_ext = torch.cat([_ref_block(seed, g, L, amplitude, dev)
                         for g in range(g0 - 1, g0 - 1 + E)])
    W = ref_ext.shape[0]

    delays = torch.from_numpy(truth.delays).to(dev)
    delayed = torch.fft.ifft(torch.fft.fft(ref_ext)[None, :] * delay_ramp(W, delays), dim=-1)
    if np.any(truth.ppm != 0.0):
        t_abs = (g0 - 1) * L + torch.arange(W, dtype=torch.float32, device=dev)
        adv = -torch.from_numpy(truth.ppm).to(dev)[:, None] * 1e-6 * t_abs[None, :]
        delayed = farrow_fractional_delay(delayed, adv)

    rot = torch.from_numpy(truth.gains * np.exp(1j * truth.phases)).to(dev, torch.complex64)
    noise_amp = amplitude / np.sqrt(10.0 ** (truth.snr_db / 10.0))
    noise = _cnormal((N, S * L), _seeded(dev, seed, 0xA0A0 + slab_idx), dev) * noise_amp
    interior = delayed[:, L: (S + 1) * L] * rot[:, None] + noise
    ref_u8 = quantize_u8(ref_ext[L: (S + 1) * L].reshape(S, L))
    sig_u8 = quantize_u8(interior.reshape(N, S, L).transpose(0, 1))
    return sig_u8, ref_u8
