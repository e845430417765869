"""Four-step (Bailey) FFT as matrix products, in the transpose-free permuted
frequency layout (port of ``coherent_rtlsdr_tpu/kernels/fft4step.py``).

For W = m*m the W-point DFT factors as

    A[n2, n1] = x[n1 + m*n2]            (row-major reshape)
    B         = F_m @ A                  (DFT over n2)
    C         = B * T,  T[k2, n1] = exp(-2*pi*i*k2*n1/W)
    D         = C @ F_m                  (DFT over n1)
    X[k2 + m*k1] = D[k2, k1]

and the inverse maps the permuted layout straight back to natural time order:

    C = D @ conj(F_m)/m;  B = C * conj(T);  A = conj(F_m)/m @ B;  x = A.flat

``precision="bf16"`` takes bf16 operands and accumulates in float32, as
the JAX package's ``FFT4Step(precision="bf16")`` does: the products run as
float32 matmuls of bf16-rounded operands (a product of two bf16 values is
exact in float32), so the result equals the bf16/f32 matmul up to summation
order. ``precision="f32"`` keeps float32 operands. On the card every
product runs with TF32 off (``exact_f32_matmul``).
"""

import contextlib
from typing import Tuple

import numpy as np
import torch


def supported_fft_len(fft_len: int) -> bool:
    m = int(round(np.sqrt(fft_len)))
    return m * m == fft_len and m in (64, 128, 256)


def _dft_matrix(m: int) -> Tuple[np.ndarray, np.ndarray]:
    """DFT matrix F_m as float32 (re, im), built in float64 exactly as the
    JAX package builds it, so the tables are bit-equal."""
    n = np.arange(m)
    w = np.exp(-2j * np.pi * np.outer(n, n) / m)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def _twiddle(m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Four-step twiddle T[k2, n1] = exp(-2*pi*i*k2*n1/W) as float32 (re, im)."""
    W = m * m
    k2 = np.arange(m)[:, None]
    n1 = np.arange(m)[None, :]
    t = np.exp(-2j * np.pi * (k2 * n1) / W)
    return t.real.astype(np.float32), t.imag.astype(np.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bf16 value (ties to even), kept float32."""
    return x.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def exact_f32_matmul(x: torch.Tensor):
    """float32 matmuls without TF32 while ``x`` lies on the card; the
    caller's setting is restored on exit."""
    if not x.is_cuda:
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def cmatmul(are, aim, bre, bim):
    """(are + i aim) @ (bre + i bim) as four float32 matmuls."""
    return are @ bre - aim @ bim, are @ bim + aim @ bre


class FFT4Step:
    """Transform pair for one ``fft_len`` on one device, at ``precision``
    "bf16" or "f32"."""

    def __init__(self, fft_len: int, device="cuda", precision: str = "bf16"):
        m = int(round(np.sqrt(fft_len)))
        if m * m != fft_len:
            raise ValueError(f"fft_len {fft_len} is not a square")
        if precision not in ("bf16", "f32"):
            raise ValueError(f"precision must be 'bf16' or 'f32', got {precision!r}")
        self.fft_len = fft_len
        self.m = m
        self.precision = precision
        self.device = torch.device(device)
        self._round = bf16_round if precision == "bf16" else (lambda x: x)
        fre, fim = _dft_matrix(m)
        tre, tim = _twiddle(m)
        as_t = lambda a: torch.from_numpy(a).to(self.device)
        self.fre, self.fim = self._round(as_t(fre)), self._round(as_t(fim))
        self.fire = self._round(as_t(fre / m))
        self.fiim = self._round(as_t(-fim / m))
        self.tre, self.tim = as_t(tre), as_t(tim)
        k2 = torch.arange(m, dtype=torch.int32, device=self.device)[:, None]
        k1 = torch.arange(m, dtype=torch.int32, device=self.device)[None, :]
        self._kgrid = k2 + m * k1
        self._fgrid = torch.where(self._kgrid < fft_len // 2, self._kgrid,
                                  self._kgrid - fft_len).to(torch.float32) / fft_len

    def fft_planes(self, are: torch.Tensor, aim: torch.Tensor):
        """Forward transform of planes ``A[..., n2, n1]`` already rounded to
        the precision -> the float32 permuted spectrum planes (dre, dim)."""
        with exact_f32_matmul(are):
            bre, bim = cmatmul(self.fre, self.fim, are, aim)
            cre = bre * self.tre - bim * self.tim
            cim = bre * self.tim + bim * self.tre
            return cmatmul(self._round(cre), self._round(cim), self.fre, self.fim)

    def fft(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[..., W]`` complex -> permuted spectrum ``[..., m(k2), m(k1)]``
        where the natural bin index is ``k = k2 + m*k1``."""
        m = self.m
        A = x.reshape(*x.shape[:-1], m, m)
        return torch.complex(*self.fft_planes(self._round(A.real.float()),
                                              self._round(A.imag.float())))

    def ifft(self, Xp: torch.Tensor) -> torch.Tensor:
        """Permuted spectrum ``[..., m, m]`` -> natural-order time ``[..., W]``."""
        m = self.m
        with exact_f32_matmul(Xp):
            cre, cim = cmatmul(self._round(Xp.real.float()), self._round(Xp.imag.float()),
                               self.fire, self.fiim)
            bre = cre * self.tre + cim * self.tim
            bim = cim * self.tre - cre * self.tim
            are, aim = cmatmul(self.fire, self.fiim, self._round(bre), self._round(bim))
        return torch.complex(are, aim).reshape(*Xp.shape[:-2], m * m)

    def freq_index_grid(self) -> torch.Tensor:
        """int32 ``[m, m]``: natural bin index k = k2 + m*k1 at (k2, k1)."""
        return self._kgrid

    def signed_freq_grid(self) -> torch.Tensor:
        """f32 ``[m, m]``: signed frequency k/W (cycles/sample) per position."""
        return self._fgrid
