"""Pipeline configuration, state and output containers (port of
``coherent_rtlsdr_tpu/pipeline/state.py``).

The public layouts are the JAX package's, so the two can be compared leaf
by leaf: ``phase`` is ``[N, 2]`` float32 (re, im); the history is the
signed capture bytes in the wide ``[N, m/2, 2m]`` layout on the fused path
and ``[N, L, 2]`` float32 (re, im) pairs on the generic path; fused wire
bytes are flat ``[.., N, 2L]`` int8. Per-channel capture seqnums are
uint32 in the JAX package; PyTorch's uint32 arithmetic is incomplete, so
``last_seq`` is int64 holding the same value (always in [0, 2^32)), and
``pack_state`` writes the same int32 bit pattern as the JAX bitcast.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch import constants
from coherent_rtlsdr_tpu_torch.ops.convert import i8_iq_to_c64

SEQ_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration (same fields and defaults as the JAX package)."""

    n_channels: int
    block_len: int = constants.DEFAULT_BLOCK_LEN
    fs: float = constants.DEFAULT_FS
    sync_threshold: float = constants.SYNC_THRESHOLD
    phase_alpha: float = constants.PHASE_EMA_ALPHA
    ctrl_gain: float = constants.CTRL_FRAC_T
    ctrl_scale: float = constants.CTRL_SCALE
    # Max commanded advance; must stay within the overlap-save safe range.
    max_delay: Optional[float] = None
    # Fractional-lag estimator: "phase_slope" | "parabolic" | "integer" |
    # "phase_zoom" (the only one of fft_impl="fused").
    lag_method: str = "phase_slope"
    min_corr_mag: float = 0.1
    # Spectral backend (kernels/backend.py): "xla" | "mxu" | "pallas" |
    # "fused" | "auto"; mxu_precision ("bf16" | "f32") is read by "mxu".
    fft_impl: str = "xla"
    mxu_precision: str = "bf16"

    def __post_init__(self):
        if self.max_delay is None:
            object.__setattr__(self, "max_delay", self.block_len / 2.0 - 8.0)


def fused_m(cfg: PipelineConfig) -> int:
    """Four-step size m of the fused path: W = 2L = m*m."""
    m = int(round((2 * cfg.block_len) ** 0.5))
    if m * m != 2 * cfg.block_len:
        raise ValueError(f"fft_impl='fused' needs 2L square, got L = {cfg.block_len}")
    return m


@dataclasses.dataclass
class PipelineState:
    delay: torch.Tensor      # [N] f32 commanded advance (samples)
    phase: torch.Tensor      # [N, 2] f32 unit-modulus correction factor (re, im)
    lag: torch.Tensor        # [N] f32 last measured absolute lag
    mag: torch.Tensor        # [N] f32 last correlation coefficient
    papr: torch.Tensor       # [N] f32 last correlation PAPR
    synced: torch.Tensor     # [N] bool
    hist: torch.Tensor       # previous block: [N, m/2, 2m] i8 signed bytes
                             # (fused) or [N, L, 2] f32 (re, im)
    ref_hist: torch.Tensor   # previous reference block: [m/2, 2m] i8 or [L, 2] f32
    block_idx: torch.Tensor  # i32 scalar
    last_seq: torch.Tensor   # [N] i64, a uint32 value: last capture seqnum
    gaps: torch.Tensor       # [N] i32 cumulative gap events

    @property
    def phase_c(self) -> torch.Tensor:
        return torch.complex(self.phase[..., 0], self.phase[..., 1])


@dataclasses.dataclass
class Telemetry:
    lag: torch.Tensor       # [N] absolute measured lag (samples)
    residual: torch.Tensor  # [N] lag remaining after the applied correction
    mag: torch.Tensor       # [N]
    papr: torch.Tensor      # [N]
    phase: torch.Tensor     # [N, 2] f32 applied correction factor (re, im)
    synced: torch.Tensor    # [N] bool
    rms: torch.Tensor       # [N] block RMS
    gap: torch.Tensor       # [N] bool seqnum discontinuity this block
    gaps: torch.Tensor      # [N] i32 cumulative gap events

    @property
    def phase_c(self) -> torch.Tensor:
        return torch.complex(self.phase[..., 0], self.phase[..., 1])


def stack_telemetry(ts) -> Telemetry:
    """Telemetry of consecutive blocks stacked along a new leading axis."""
    return Telemetry(**{f.name: torch.stack([getattr(t, f.name) for t in ts])
                        for f in dataclasses.fields(Telemetry)})


@dataclasses.dataclass
class BlockOutput:
    """One block's output and telemetry. The fused path emits the int8
    wire frame straight from the apply kernel as flat interleaved bytes
    (``wire [N, 2L]``, ``wire_ref [2L]``), and ``aligned``/``ref`` are the
    complex64 reconstructions from those bytes (what clients receive),
    computed on access. The generic path emits ``aligned [N, L]`` and
    ``ref [L]`` complex64 and no wire bytes; the drivers quantize them."""

    telemetry: Telemetry
    wire: Optional[torch.Tensor] = None       # [N, 2L] int8 (fused)
    wire_ref: Optional[torch.Tensor] = None   # [2L] int8 (fused)
    aligned_c64: Optional[torch.Tensor] = None  # [N, L] complex64 (generic)
    ref_c64: Optional[torch.Tensor] = None      # [L] complex64 (generic)

    @property
    def aligned(self) -> torch.Tensor:
        if self.aligned_c64 is not None:
            return self.aligned_c64
        return i8_iq_to_c64(self.wire.reshape(*self.wire.shape[:-1], -1, 2))

    @property
    def ref(self) -> torch.Tensor:
        if self.ref_c64 is not None:
            return self.ref_c64
        return i8_iq_to_c64(self.wire_ref.reshape(*self.wire_ref.shape[:-1], -1, 2))


# Column order of pack_telemetry (one [.., N, 10] f32 tensor).
TELEMETRY_COLS = (
    "lag", "residual", "mag", "papr", "rms",
    "phase_re", "phase_im", "synced", "gap", "gaps",
)


def pack_telemetry(t: Telemetry) -> torch.Tensor:
    """Telemetry as one dense [.., N, 10] f32 tensor (TELEMETRY_COLS order);
    bools travel as 0.0/1.0."""
    return torch.stack([
        t.lag, t.residual, t.mag, t.papr, t.rms,
        t.phase[..., 0], t.phase[..., 1],
        t.synced.to(torch.float32), t.gap.to(torch.float32), t.gaps.to(torch.float32),
    ], dim=-1)


# Packed-state layout (pack_state / unpack_state).
PPACK_COLS = ("delay", "phase_re", "phase_im", "lag", "mag", "papr")
IPACK_COLS = ("synced", "last_seq", "gaps", "block_idx")


def _seq_to_i32(seq: torch.Tensor) -> torch.Tensor:
    """uint32 values (as int64) -> the int32 with the same bits."""
    return torch.where(seq >= 2**31, seq - 2**32, seq).to(torch.int32)


def pack_state(s: PipelineState):
    """PipelineState as three tensors:

      ppack [N, 6] f32  - PPACK_COLS
      ipack [N, 4] i32  - IPACK_COLS (last_seq as the int32 of the same bits;
                          block_idx repeated down the column)
      hist  [N+1, m/2, 2m] i8 (fused) or [N+1, L, 2] f32 (generic) -
            ref_hist row 0, then the channel rows
    """
    ppack = torch.stack(
        [s.delay, s.phase[..., 0], s.phase[..., 1], s.lag, s.mag, s.papr], dim=-1)
    ipack = torch.stack([
        s.synced.to(torch.int32),
        _seq_to_i32(s.last_seq),
        s.gaps,
        s.block_idx.to(torch.int32).expand(s.gaps.shape),
    ], dim=-1)
    hist = torch.cat([s.ref_hist[None], s.hist], dim=0)
    return ppack, ipack, hist


def unpack_state(ppack, ipack, hist) -> PipelineState:
    """Inverse of :func:`pack_state`; every leaf round-trips exactly."""
    return PipelineState(
        delay=ppack[:, 0],
        phase=ppack[:, 1:3],
        lag=ppack[:, 3],
        mag=ppack[:, 4],
        papr=ppack[:, 5],
        synced=ipack[:, 0].to(torch.bool),
        last_seq=ipack[:, 1].to(torch.int64) & SEQ_MASK,
        gaps=ipack[:, 2],
        block_idx=ipack[0, 3],
        hist=hist[1:],
        ref_hist=hist[0],
    )


def pack_state_host(s: PipelineState, device="cuda"):
    """:func:`pack_state` at the host edge: leaves that may be numpy arrays
    (an :func:`unpack_state_host` view, edited with ``dataclasses.replace``),
    torch tensors on any device, or a mix, packed on the CPU and uploaded
    to ``device``, one copy each."""
    return tuple(t.to(device) for t in pack_state(state_from_numpy(s, "cpu")))


def unpack_state_host(ppack, ipack, hist) -> PipelineState:
    """:func:`unpack_state` at the host edge: the three packed tensors
    fetched once each, and the state's leaves as numpy arrays in the JAX
    package's dtypes (``last_seq`` uint32). The host touchpoints (status,
    checkpoint, hot-plug) read numpy, and :func:`pack_state_host` takes
    such a view back. The fetch copies, so editing the leaves leaves the
    packed tensors as they were, on the CPU too."""
    host = (t.to("cpu", copy=True) for t in (ppack, ipack, hist))
    return PipelineState(**state_to_numpy(unpack_state(*host)))


def init_state(cfg: PipelineConfig, device="cuda") -> PipelineState:
    """Initial state on ``device``: zero history in the layout of
    ``cfg.fft_impl``, unit phase, no sync."""
    N, L = cfg.n_channels, cfg.block_len
    dev = torch.device(device)
    phase = torch.zeros((N, 2), dtype=torch.float32, device=dev)
    phase[:, 0] = 1.0
    zeros = lambda: torch.zeros((N,), dtype=torch.float32, device=dev)
    if cfg.fft_impl == "fused":
        m = fused_m(cfg)
        hist = torch.zeros((N, L // m, 2 * m), dtype=torch.int8, device=dev)
        ref_hist = torch.zeros((L // m, 2 * m), dtype=torch.int8, device=dev)
    else:
        hist = torch.zeros((N, L, 2), dtype=torch.float32, device=dev)
        ref_hist = torch.zeros((L, 2), dtype=torch.float32, device=dev)
    return PipelineState(
        delay=zeros(), phase=phase, lag=zeros(), mag=zeros(), papr=zeros(),
        synced=torch.zeros((N,), dtype=torch.bool, device=dev),
        hist=hist, ref_hist=ref_hist,
        block_idx=torch.zeros((), dtype=torch.int32, device=dev),
        last_seq=torch.zeros((N,), dtype=torch.int64, device=dev),
        gaps=torch.zeros((N,), dtype=torch.int32, device=dev),
    )


# The JAX package's leaf dtypes; the history keeps its own (int8 on the
# fused path, float32 on the generic path).
_NUMPY_DTYPES = {
    "delay": np.float32, "phase": np.float32, "lag": np.float32, "mag": np.float32,
    "papr": np.float32, "synced": np.bool_, "hist": None, "ref_hist": None,
    "block_idx": np.int32, "last_seq": np.uint32, "gaps": np.int32,
}


def state_from_numpy(leaves, device="cuda") -> PipelineState:
    """The port's state from the JAX package's ``PipelineState`` leaves as
    numpy arrays (a mapping or any object with the leaf attributes), e.g. to
    start both steps from the same mid-stream state."""
    get = leaves.__getitem__ if isinstance(leaves, dict) else lambda k: getattr(leaves, k)
    out = {}
    for name, dt in _NUMPY_DTYPES.items():
        x = get(name)
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
        # np.array, not np.ascontiguousarray: the latter turns the 0-d
        # block_idx into shape (1,).
        a = np.array(x, dtype=np.int64 if name == "last_seq" else dt, order="C")
        out[name] = torch.from_numpy(a).to(device)
    return PipelineState(**out)


def state_to_numpy(s: PipelineState) -> dict:
    """The port's state as numpy leaves in the JAX package's dtypes
    (``last_seq`` back to uint32)."""
    out = {}
    for name, dt in _NUMPY_DTYPES.items():
        a = getattr(s, name).cpu().numpy()
        out[name] = a if dt is None else a.astype(dt)
    return out
