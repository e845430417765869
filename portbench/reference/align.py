"""The plain reference of the fused alignment: the same measure -> control or
smoother -> apply chain as the port, from the same raw bytes, in float64
with ``torch.fft``, natural frequency order.

It imports nothing of the port. It follows the port's published semantics
(``pipeline/step.py``, ``pipeline/offline.py``, ``pipeline/control.py`` and
the phase-zoom estimator of ``kernels/fused.py``), restated here:

* window t of a channel is blocks (t - 1, t) of int8 samples / 127, W = 2L
  points; D is its DFT, R the reference window's, G = D conj(R);
* phase zoom: 8-bin bands of G, the phase slope between neighbouring bands
  (without the pair that straddles W/2) gives the integer lag; G deramped by
  it, 2m-bin bands (W = m*m) give the fraction, clamped to +-4; z is the
  deramped G at the fractional lag, summed; mag = |z| / sqrt(sum|D|^2
  sum|R|^2);
* streaming: err = lag - delay, delay += 0.9 * 100 tanh(err / 100) where mag
  >= 0.1, clipped to +-(L/2 - 8); the phase factor is the unit EMA (weight
  0.5) of conj(z)/|z| where mag >= 0.1;
* offline ("global"): delay = sum(q lag) / sum(q), q = mag^2 where mag >=
  0.1; phase = unit(sum conj(z)/|z| over those windows);
* apply: D advanced by the delay and turned by the phase factor, inverse
  DFT, samples [L/2, 3L/2) x 127, rounded half to even, saturated to int8;
  the reference channel goes out raw at the same latency.

``precision="fp8"`` is the control: the transforms as the four-step matrix
products that the port's kernels compute, with every product operand
rounded to 3 mantissa bits (fp8 e4m3, with scales that keep every value in
range) and float32 sums, one step below the port's bf16 operands.
"""

import math

import numpy as np
import torch

IQ_SCALE = 1.0 / 127.0


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded half to even to ``bits`` explicit mantissa bits, with an
    unbounded exponent (bits = 7 is bf16, 3 is fp8 e4m3)."""
    mant, exp = torch.frexp(x)
    s = float(2 ** (bits + 1))
    return torch.ldexp(torch.round(mant * s) / s, exp)


def _cmatmul(ar, ai, br, bi):
    return ar @ br - ai @ bi, ar @ bi + ai @ br


class Transform:
    """The W-point DFT of the windows and the centre half of the inverse,
    in float64 (``precision="f64"``) or as four-step products with operands
    rounded to ``fp8``."""

    def __init__(self, W: int, device, precision: str = "f64"):
        if precision not in ("f64", "fp8"):
            raise ValueError(f"precision must be 'f64' or 'fp8', got {precision!r}")
        m = math.isqrt(W)
        self.W, self.m, self.precision = W, m, precision
        self.device = torch.device(device)
        if precision == "fp8":
            n = np.arange(m)
            f = np.exp(-2j * np.pi * np.outer(n, n) / m)
            t = np.exp(-2j * np.pi * np.outer(n, n) / W)
            as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
            rnd = self.rnd
            self.fr, self.fi = rnd(as_t(f.real)), rnd(as_t(f.imag))
            self.ir, self.ii = rnd(as_t(f.real / m)), rnd(as_t(-f.imag / m))
            self.tr, self.ti = as_t(t.real), as_t(t.imag)

    def rnd(self, x):
        return round_mantissa(x, 3)

    def dequant(self, u8: torch.Tensor) -> torch.Tensor:
        """uint8 offset-binary ``[..., L, 2]`` -> complex128 ``[..., L]``
        (int8 / 127; in the control, rounded to fp8)."""
        f = (u8.to(torch.float64) - 128.0) * IQ_SCALE
        if self.precision == "fp8":
            f = self.rnd(f.to(torch.float32)).to(torch.float64)
        return torch.complex(f[..., 0], f[..., 1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """complex ``[..., W]`` time -> complex128 natural-order spectrum."""
        if self.precision == "f64":
            return torch.fft.fft(x.to(torch.complex128), dim=-1)
        m = self.m
        a = x.reshape(*x.shape[:-1], m, m)
        with _exact_f32(a):
            br, bi = _cmatmul(self.fr, self.fi, a.real.float(), a.imag.float())
            cr = br * self.tr - bi * self.ti
            ci = br * self.ti + bi * self.tr
            dr, di = _cmatmul(self.rnd(cr), self.rnd(ci), self.fr, self.fi)
        d = torch.complex(dr, di).to(torch.complex128)            # [..., k2, k1]
        return d.transpose(-1, -2).reshape(*x.shape[:-1], self.W)  # k = k2 + m k1

    def store(self, D: torch.Tensor) -> torch.Tensor:
        """The spectrum as the measure hands it to the apply (the port keeps
        bf16; the control fp8)."""
        if self.precision == "f64":
            return D
        stored = torch.complex(self.rnd(D.real.float()), self.rnd(D.imag.float()))
        return stored.to(torch.complex128)

    def inverse_centre(self, Y: torch.Tensor) -> torch.Tensor:
        """natural-order spectrum ``[..., W]`` -> time samples [W/4, 3W/4)."""
        W, m = self.W, self.m
        if self.precision == "f64":
            return torch.fft.ifft(Y, dim=-1)[..., W // 4: 3 * W // 4]
        p = Y.reshape(*Y.shape[:-1], m, m).transpose(-1, -2)       # [..., k2, k1]
        rows = slice(m // 4, 3 * m // 4)
        with _exact_f32(p):
            cr, ci = _cmatmul(self.rnd(p.real.float()), self.rnd(p.imag.float()), self.ir, self.ii)
            br = cr * self.tr + ci * self.ti
            bi = ci * self.tr - cr * self.ti
            ar, ai = _cmatmul(self.ir[rows], self.ii[rows], self.rnd(br), self.rnd(bi))
        return torch.complex(ar, ai).to(torch.complex128).reshape(*Y.shape[:-1], W // 2)


class _exact_f32:
    """float32 matmuls without TF32 while on the card."""

    def __init__(self, x):
        self.cuda = x.is_cuda

    def __enter__(self):
        if self.cuda:
            self.saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32 = self.saved


def _signed_freq(W: int, device) -> torch.Tensor:
    k = torch.arange(W, dtype=torch.float64, device=device)
    return torch.where(k < W // 2, k, k - W) / W


def _iramp(W: int, d_int: torch.Tensor) -> torch.Tensor:
    """(k * d) mod W / W over the bins k, for integer delays ``d_int [...]``:
    ``[..., W]`` float64, exact in int64."""
    k = torch.arange(W, dtype=torch.int64, device=d_int.device)
    dm = torch.remainder(d_int.to(torch.int64), W)[..., None]
    return torch.remainder(k * dm, W).to(torch.float64) / W


def phase_zoom(G: torch.Tensor):
    """Cross-spectra ``[..., W]`` -> (lag, z, sum |G|^2), each ``[...]``."""
    W = G.shape[-1]
    m = math.isqrt(W)
    g1 = G.reshape(*G.shape[:-1], W // 8, 8).sum(-1)
    p1 = g1[..., 1:] * g1[..., :-1].conj()
    p1[..., W // 16 - 1] = 0
    d1 = -torch.angle(p1.sum(-1)) * ((W // 8) / (2 * math.pi))
    int_lag = torch.round(d1)
    gc = G * torch.exp(2j * math.pi * _iramp(W, int_lag))
    M2 = m // 2
    g2 = gc.reshape(*G.shape[:-1], M2, 2 * m).sum(-1)
    p2 = g2[..., 1:] * g2[..., :-1].conj()
    p2[..., M2 // 2 - 1] = 0
    frac = torch.clamp(-torch.angle(p2.sum(-1)) * (M2 / (2 * math.pi)), -4.0, 4.0)
    f = _signed_freq(W, G.device)
    z = (gc * torch.exp(2j * math.pi * frac[..., None] * f)).sum(-1)
    return int_lag + frac, z, (G.real ** 2 + G.imag ** 2).sum(-1)


def measure(tf: Transform, sig_prev, sig_cur, ref_prev, ref_cur):
    """Windows of uint8 blocks ``sig [..., N, L, 2]``, ``ref [..., L, 2]``:
    (lag, z, mag, papr) ``[..., N]`` and the stored spectra D ``[..., N, W]``."""
    D = tf.forward(torch.cat([tf.dequant(sig_prev), tf.dequant(sig_cur)], dim=-1))
    R = tf.forward(torch.cat([tf.dequant(ref_prev), tf.dequant(ref_cur)], dim=-1))[..., None, :]
    lag, z, eg = phase_zoom(D * R.conj())
    esig = (D.real ** 2 + D.imag ** 2).sum(-1)
    eref = (R.real ** 2 + R.imag ** 2).sum(-1)
    zabs = torch.abs(z)
    mag = zabs / torch.clamp(torch.sqrt(esig * eref), min=1e-30)
    papr = zabs * zabs / torch.clamp(eg, min=1e-30)
    return lag, z, mag, papr, tf.store(D)


def apply(tf: Transform, D: torch.Tensor, advance: torch.Tensor, phase: torch.Tensor):
    """Spectra ``[..., W]``, advance ``[...]`` float, phase factor ``[...]``
    complex -> wire samples int8 ``[..., L, 2]``."""
    W = tf.W
    d = -advance.to(torch.float64)
    di = torch.floor(d)
    ph = _iramp(W, di) + _signed_freq(W, D.device) * (d - di)[..., None]
    Y = D * torch.exp(-2j * math.pi * ph) * phase.to(torch.complex128)[..., None]
    y = tf.inverse_centre(Y) / IQ_SCALE
    q = torch.stack([y.real, y.imag], dim=-1)
    return torch.clamp(torch.round(q), -128.0, 127.0).to(torch.int8)


def ref_wire(ref_prev: torch.Tensor, ref_cur: torch.Tensor) -> torch.Tensor:
    """The reference channel's frame: uint8 blocks ``[..., L, 2]`` -> int8
    samples [L/2, L) of the previous block and [0, L/2) of this one."""
    L = ref_cur.shape[-2]
    cat = torch.cat([ref_prev[..., L // 2:, :], ref_cur[..., : L // 2, :]], dim=-2)
    return (cat.to(torch.int16) - 128).to(torch.int8)


def unit(z):
    """z / |z|, and 1 where z == 0 (numpy or torch)."""
    mod = abs(z)
    return np.where(mod > 0, z / np.where(mod > 0, mod, 1.0), 1.0) if isinstance(z, np.ndarray) \
        else torch.where(mod > 0, z / torch.where(mod > 0, mod, 1.0), torch.ones_like(z))


class Params:
    """The control and smoothing constants of a configuration."""

    def __init__(self, cfg: dict):
        self.max_delay = cfg["block_len"] / 2.0 - 8.0
        self.ctrl_gain = cfg["ctrl_gain"]
        self.ctrl_scale = cfg["ctrl_scale"]
        self.phase_alpha = cfg["phase_alpha"]
        self.min_corr_mag = cfg["min_corr_mag"]


def control_loop(p: Params, lag: np.ndarray, mag: np.ndarray, z: np.ndarray):
    """The streaming control law and phase EMA over blocks ``[G, N]`` from
    the initial state (delay 0, phase 1): the applied (delay, phase) ``[G, N]``."""
    G, N = lag.shape
    delays = np.empty((G, N))
    phases = np.empty((G, N), np.complex128)
    delay = np.zeros(N)
    phase = np.ones(N, np.complex128)
    for g in range(G):
        good = mag[g] >= p.min_corr_mag
        step = p.ctrl_gain * p.ctrl_scale * np.tanh((lag[g] - delay) / p.ctrl_scale)
        delay = np.clip(np.where(good, delay + step, delay), -p.max_delay, p.max_delay)
        ema = unit((1.0 - p.phase_alpha) * phase + p.phase_alpha * unit(np.conj(z[g])))
        phase = np.where(good, ema, phase)
        delays[g], phases[g] = delay, phase
    return delays, phases


def global_smoothing(p: Params, lag: torch.Tensor, mag: torch.Tensor, z: torch.Tensor):
    """Offline "global" smoothing over windows ``[T', N]``: (delay, phase) ``[N]``."""
    w = (mag >= p.min_corr_mag).to(torch.float64)
    q = w * mag * mag
    den = q.sum(0)
    delay = (q * lag).sum(0) / torch.where(den > 0, den, torch.ones_like(den))
    phase = unit((unit(z.conj()) * w).sum(0))
    return torch.clamp(delay, -p.max_delay, p.max_delay), phase


def align_offline(tf: Transform, p: Params, sig_u8, ref_u8, chunk: int = 8):
    """A capture ``sig [T, N, L, 2]``, ``ref [T, L, 2]`` uint8 -> dict of
    lag, mag, z ``[T-1, N]``, delay, phase ``[N]``, wire ``[T-1, N, L, 2]``
    int8 and wire_ref ``[T-1, L, 2]`` int8, all on the device of the bytes."""
    T = sig_u8.shape[0]
    spans = [(a, min(a + chunk, T - 1)) for a in range(0, T - 1, chunk)]
    parts = [measure(tf, sig_u8[a:b], sig_u8[a + 1:b + 1], ref_u8[a:b], ref_u8[a + 1:b + 1])[:4]
             for a, b in spans]
    lag, z, mag, papr = (torch.cat([q[i] for q in parts]) for i in range(4))
    delay, phase = global_smoothing(p, lag, mag, z)
    wire = []
    for a, b in spans:
        D = measure(tf, sig_u8[a:b], sig_u8[a + 1:b + 1], ref_u8[a:b], ref_u8[a + 1:b + 1])[4]
        wire.append(apply(tf, D, delay.expand(b - a, -1), phase.expand(b - a, -1)))
    return dict(lag=lag, mag=mag, z=z, papr=papr, delay=delay, phase=phase,
                wire=torch.cat(wire), wire_ref=ref_wire(ref_u8[:-1], ref_u8[1:]))


class StreamReference:
    """The server's output for the periodic stream of ``sig [P, N, L, 2]``,
    ``ref [P, L, 2]`` uint8 replayed from block 0: block g is block g mod P
    of the period, and the server starts from a zero history."""

    def __init__(self, tf: Transform, p: Params, sig_u8, ref_u8, chunk: int = 8):
        self.tf, self.p, self.sig, self.ref = tf, p, sig_u8, ref_u8
        P = sig_u8.shape[0]
        self.P = P
        # window w of the period (w >= 1 in the stream): blocks (w-1 mod P, w)
        prev = lambda a, b: torch.remainder(torch.arange(a - 1, b - 1), P)
        parts = [measure(tf, sig_u8[prev(a, b)], sig_u8[a:b], ref_u8[prev(a, b)], ref_u8[a:b])[:3]
                 for a in range(0, P, chunk) for b in [min(a + chunk, P)]]
        self.lag, self.z, self.mag = (torch.cat([q[i] for q in parts]).cpu().numpy()
                                      for i in range(3))
        # the stream's first window: a zero history (int8 0 = u8 128)
        lag0, z0, mag0, _, _ = measure(tf, *self._first())
        self.lag0, self.z0, self.mag0 = lag0.cpu().numpy(), z0.cpu().numpy(), mag0.cpu().numpy()

    def _first(self):
        return (torch.full_like(self.sig[0], 128), self.sig[0],
                torch.full_like(self.ref[0], 128), self.ref[0])

    def follow(self, n_blocks: int):
        """The applied (delay, phase) ``[G, N]`` of the first ``n_blocks``."""
        idx = np.arange(n_blocks) % self.P
        pick = lambda table, first: np.concatenate([first[None], table[idx[1:]]])[:n_blocks]
        self.delays, self.phases = control_loop(self.p, pick(self.lag, self.lag0),
                                                pick(self.mag, self.mag0), pick(self.z, self.z0))
        return self.delays, self.phases

    def frame(self, g: int):
        """Block g's frame as int8 ``[N + 1, L, 2]``, reference channel first
        (after :meth:`follow` has covered g)."""
        P, w = self.P, g % self.P
        if g == 0:
            sp, sc, rp, rc = self._first()
        else:
            sp, sc, rp, rc = self.sig[(w - 1) % P], self.sig[w], self.ref[(w - 1) % P], self.ref[w]
        D = measure(self.tf, sp, sc, rp, rc)[4]
        dev = D.device
        wire = apply(self.tf, D, torch.from_numpy(self.delays[g]).to(dev),
                     torch.from_numpy(self.phases[g]).to(dev))
        return torch.cat([ref_wire(rp, rc)[None], wire])
