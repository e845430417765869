"""The offline align engines and the streaming step over a (time, channel)
mesh (port of ``coherent_rtlsdr_tpu/parallel/sharded.py``).

Each runner is called by every rank of the mesh with its own shard
(``parallel/mesh.py:local_shard``) and returns its own output shard, as the local
function of the JAX package's ``shard_map`` does; its tensors stay on the
device of the inputs (the rank's card, or the CPU where the caller passes
CPU tensors, which run the kernels' plain versions).

Communication inventory (what replaces ``ppermute`` and ``psum``):

  * overlap-save halo: each time shard sends its LAST block of raw capture
    bytes (signal + reference) to the next time shard, one
    ``batch_isend_irecv`` on the time group; shard 0 takes a block of u8
    0x80, which is i8 0 and complex 0 (the streaming step's zero history).
  * reference broadcast: the reference channel is replicated over the
    channel axis by the caller (every rank holds it); no collective.
  * smoother reductions: "global" smoothing is quality-weighted sums over
    all windows, ``all_reduce(SUM)`` on the time group; the EMA's carry
    crosses time shards by one ``all_gather`` on the time group.

Channel shards never communicate.
"""

import dataclasses

import torch
import torch.distributed as dist

from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
from coherent_rtlsdr_tpu_torch.ops.convert import c64_to_i8_iq, u8_to_c64, u8_to_i8
from coherent_rtlsdr_tpu_torch.ops.delay import apply_delay_phase_freq
from coherent_rtlsdr_tpu_torch.ops.phase import phase_correction_estimate
from coherent_rtlsdr_tpu_torch.ops.xcorr import lag_estimate_from_spectra
from coherent_rtlsdr_tpu_torch.parallel.mesh import (
    TIME_AXIS,
    channel_slice,
    comm_tensor,
    from_comm_tensor,
    mesh_coords,
    mesh_shape,
)
from coherent_rtlsdr_tpu_torch.pipeline.offline import TimeAxis, _ema_scan, align_offline
from coherent_rtlsdr_tpu_torch.pipeline.state import PipelineConfig, PipelineState, fused_m
from coherent_rtlsdr_tpu_torch.pipeline.step import step

ZERO_U8 = 0x80   # offset-binary zero: i8 0, complex 0


def _psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over the time shards (``all_reduce`` on the time
    group), on ``x``'s device; ``x`` may be overwritten."""
    group = mesh.get_group(TIME_AXIS)
    buf = comm_tensor(x, group)
    dist.all_reduce(buf, group=group)
    return from_comm_tensor(buf, x)


def _halo_prev_block(xs, mesh):
    """The previous time shard's last block of each raw-byte tensor of
    ``xs`` (each ``[T_loc, ...]`` uint8), one ``[...]`` block apiece; time
    shard 0 gets blocks of u8 0x80 (zero IQ). Every send and receive of the
    exchange is posted in one ``batch_isend_irecv``, so no rank waits on
    another's order."""
    group = mesh.get_group(TIME_AXIS)
    n_time = mesh.size(0)
    ti = mesh_coords(mesh)[0]
    ops, bufs = [], []
    for tag, x in enumerate(xs):
        if ti + 1 < n_time:
            ops.append(dist.P2POp(dist.isend, comm_tensor(x[-1], group),
                                  dist.get_global_rank(group, ti + 1), group, tag))
        if ti > 0:
            buf = comm_tensor(torch.empty(x.shape[1:], dtype=x.dtype, device=x.device), group)
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, ti - 1),
                                  group, tag))
            bufs.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if ti == 0:
        return [torch.full(x.shape[1:], ZERO_U8, dtype=x.dtype, device=x.device) for x in xs]
    return [from_comm_tensor(b, x) for b, x in zip(bufs, xs)]


def _zero_halo_window(w: torch.Tensor, mesh) -> torch.Tensor:
    """Quality weights ``w [T_loc, N_loc]`` with time shard 0's first
    window, the one that straddles the zero halo, weighted 0: the sums then
    hold exactly the unsharded engine's terms."""
    if mesh_coords(mesh)[0] == 0:
        w = w.clone()
        w[0] = 0.0
    return w


def make_sharded_align(cfg: PipelineConfig, mesh, smoothing: str = "global"):
    """Sharded offline alignment over a (time, channel) mesh, on the
    generic ``torch.fft`` ops (the JAX runner's XLA-ops path).

    Input (this rank's shard): sig_u8 ``[T_loc, N_loc, L, 2]`` u8 (blocks
    split over time, channels over channel); ref_u8 ``[T_loc, L, 2]``
    (split over time, replicated over channel).
    Output: aligned ``[T_loc, N_loc, L]`` c64; ref_out ``[T_loc, L]`` c64;
    delay / mag ``[T_loc, N_loc]`` f32.

    Produces T output blocks over the mesh: block 0 of the first shard
    seeds from a zero halo (the streaming step's first block) and is left
    out of both reductions, so block t >= 1 matches the unsharded engine's
    block t - 1 up to reduction order. Only "global" smoothing is
    supported; "ema" raises.
    """
    if smoothing != "global":
        raise NotImplementedError(
            "sharded align supports smoothing='global' (EMA is sequential in "
            "time; use make_auto_sharded_align, the streaming step or the "
            "unsharded align for it)")
    L = cfg.block_len

    def run(sig_u8: torch.Tensor, ref_u8: torch.Tensor):
        prev_sig, prev_ref = _halo_prev_block((sig_u8, ref_u8), mesh)
        ext_sig = u8_to_c64(torch.cat([prev_sig[None], sig_u8]))   # [T_loc + 1, N_loc, L]
        ext_ref = u8_to_c64(torch.cat([prev_ref[None], ref_u8]))   # [T_loc + 1, L]
        w_sig = torch.cat([ext_sig[:-1], ext_sig[1:]], dim=-1)     # [T_loc, N_loc, 2L]
        w_ref = torch.cat([ext_ref[:-1], ext_ref[1:]], dim=-1)     # [T_loc, 2L]
        F_sig = torch.fft.fft(w_sig, dim=-1)
        F_ref = torch.fft.fft(w_ref, dim=-1)
        est = lag_estimate_from_spectra(F_sig, F_ref, method=cfg.lag_method)

        w = _zero_halo_window((est.mag >= cfg.min_corr_mag).to(torch.float32), mesh)
        q = w * est.mag * est.mag
        num, den = _psum(torch.stack([torch.sum(q * est.lag, dim=0), torch.sum(q, dim=0)]), mesh)
        delay = torch.clamp(num / torch.where(den > 0, den, 1.0), -cfg.max_delay, cfg.max_delay)

        one = torch.ones((), dtype=torch.complex64, device=F_sig.device)
        y = torch.fft.ifft(apply_delay_phase_freq(F_sig, delay[None, :], one), dim=-1)
        out_raw = y[..., L // 2: L // 2 + L]       # [T_loc, N_loc, L]
        out_ref = w_ref[..., L // 2: L // 2 + L]   # [T_loc, L]

        pc_inst = phase_correction_estimate(out_raw, out_ref[:, None])
        z = _psum(torch.sum(pc_inst * w, dim=0), mesh)   # [N_loc]
        zmag = torch.abs(z)
        pc = (z / torch.where(zmag > 0, zmag, 1.0)).to(torch.complex64)
        return (out_raw * pc[None, :, None], out_ref,
                delay[None, :].expand(est.lag.shape), est.mag)

    return run


def make_channel_sharded_align(cfg: PipelineConfig, mesh):
    """Offline align sharded over the CHANNEL axis only; takes every
    backend, the fused i8 kernels included. With channels split and time
    local, each rank runs the whole offline engine (``align_offline``:
    measure -> smooth -> apply) on its channel slice against the replicated
    reference: no collective at all, so samples/s scales with the ranks
    (each recomputes the reference's window spectra, nc/N of its work). For
    the fused backend on a mesh with a time axis, use
    :func:`make_fused_time_sharded_align`.

    Input (this rank's shard): sig_u8 ``[T, N_loc, L, 2]`` (or flat
    ``[T, N_loc, 2L]``) u8; ref_u8 ``[T, L, 2]`` (or ``[T, 2L]``), the whole
    reference. Returns (wire, delay, mag): int8 wire blocks ``[T-1, N_loc,
    2L]`` (fused) or ``[T-1, N_loc, L, 2]``, delay / mag ``[T-1, N_loc]``.
    Raises when N is not divisible by the channel shards.
    """
    n_sh = mesh_shape(mesh)[1]
    if cfg.n_channels % n_sh:
        raise ValueError(f"n_channels={cfg.n_channels} not divisible by {n_sh} shards")
    local_cfg = dataclasses.replace(cfg, n_channels=cfg.n_channels // n_sh)

    def run(sig_u8: torch.Tensor, ref_u8: torch.Tensor):
        if sig_u8.shape[1] != local_cfg.n_channels:
            raise ValueError(f"sig_u8 holds {sig_u8.shape[1]} channels; this rank's shard "
                             f"has {local_cfg.n_channels}")
        res = align_offline(local_cfg, sig_u8, ref_u8, smoothing="global")
        wire = res.wire if res.wire is not None else c64_to_i8_iq(res.aligned)
        return wire, res.delay, res.mag

    return run


def make_fused_time_sharded_align(cfg: PipelineConfig, mesh, smoothing: str = "global"):
    """The fused i8 offline engine sharded over the FULL (time, channel)
    mesh: the flagship multi-device path.

    The time-axis halo is :func:`make_sharded_align`'s, in the fused
    kernels' own currency, raw capture bytes: each time shard receives the
    previous shard's last block (signal planes + reference plane), prepends
    it, and runs the fused engine on its slab: ``measure_i8_spec`` over the
    T_loc + 1 blocks, global smoothing reduced over the time group (the
    delay's two sums and the phase pair's two in one ``all_reduce``),
    ``apply_spec_i8``. The
    windows are assembled from block pairs inside the kernels, so the halo
    is the whole exchange: N_loc * 2L bytes a shard boundary. Channel
    shards never communicate; each recomputes the reference's window
    spectra.

    Input (this rank's shard): sig_u8 ``[T_loc, N_loc, 2L]`` u8 flat bytes;
    ref_u8 ``[T_loc, 2L]`` u8.
    Output: wire ``[T_loc, N_loc, 2L]`` i8; wire_ref ``[T_loc, 2L]`` i8;
    delay / mag ``[T_loc, N_loc]`` f32.

    Window t = blocks (t-1, t): T outputs over the mesh, the first seeded
    from a zero halo and left out of the reductions, so ``wire[1:]`` of the
    gathered output matches the unsharded engine's T-1 outputs up to
    reduction order. Raises for a backend other than "fused" and for "ema".
    """
    if cfg.fft_impl != "fused":
        raise ValueError(
            "make_fused_time_sharded_align is the fused-backend runner "
            f"(got fft_impl='{cfg.fft_impl}'); use make_sharded_align for "
            "the torch.fft path")
    if smoothing != "global":
        raise NotImplementedError(
            "fused time-sharded align supports smoothing='global' (EMA is "
            "sequential in time; use make_auto_sharded_align or the "
            "streaming step for it)")
    L = cfg.block_len
    m = fused_m(cfg)

    def run(sig_u8: torch.Tensor, ref_u8: torch.Tensor):
        T_loc, N_loc = sig_u8.shape[:2]
        k = get_fused_kernels(2 * L, sig_u8.device)
        prev_sig, prev_ref = _halo_prev_block((sig_u8, ref_u8), mesh)
        raw = u8_to_i8(torch.cat([prev_sig[None], sig_u8]).reshape(T_loc + 1, N_loc, m // 2,
                                                                   2 * m))
        ref_raw = u8_to_i8(torch.cat([prev_ref[None], ref_u8]).reshape(T_loc + 1, m // 2, 2 * m))

        lag, zre, zim, mag, papr, dre, dim = k.measure_i8_spec(raw, ref_raw)

        # The delay's quality-weighted mean and the phase's (pc_inst =
        # conj(z)/|z| a window, summed, renormalized: the unsharded engine's
        # global phase) take four sums over all windows, one all_reduce.
        w = _zero_halo_window((mag >= cfg.min_corr_mag).to(torch.float32), mesh)
        q = w * mag * mag
        zabs = torch.sqrt(zre * zre + zim * zim)
        safe = torch.where(zabs > 0, zabs, 1.0)
        pr = torch.where(zabs > 0, zre / safe, 1.0)
        pi = torch.where(zabs > 0, -zim / safe, 0.0)
        num, den, zr, zi = _psum(torch.stack([torch.sum(x, dim=0)
                                              for x in (q * lag, q, pr * w, pi * w)]), mesh)
        delay = torch.clamp(num / torch.where(den > 0, den, 1.0), -cfg.max_delay, cfg.max_delay)
        zn = torch.sqrt(zr * zr + zi * zi)
        zsafe = torch.where(zn > 0, zn, 1.0)
        pcr = torch.where(zn > 0, zr / zsafe, 1.0)[None].expand(lag.shape)
        pci = torch.where(zn > 0, zi / zsafe, 0.0)[None].expand(lag.shape)

        delay_b = delay[None].expand(lag.shape)
        wire = k.apply_spec_i8(dre, dim, delay_b.contiguous(), pcr.contiguous(),
                               pci.contiguous()).reshape(T_loc, N_loc, 2 * L)
        wire_ref = torch.cat([ref_raw[:-1, m // 4:], ref_raw[1:, : m // 4]], dim=1)
        return wire, wire_ref.reshape(T_loc, 2 * L), delay_b, mag

    return run


class _ShardedTime(TimeAxis):
    """The offline engine's window axis split over the time group: sums
    are ``all_reduce``s, and the gated EMA carries across shards."""

    def __init__(self, mesh):
        self.mesh = mesh

    def sum(self, x):
        return _psum(torch.sum(x, dim=0), self.mesh)

    def ema(self, x, alpha, w):
        """y_t = (1 - a_t) y_{t-1} + a_t x_t across the shards: each shard's
        affine map over its windows, y_end = P y_in + Y with P = prod(1 -
        a_t) and Y the recurrence from 0, is gathered on the time group and
        composed in rank order into this shard's carry-in, from which the
        recurrence runs again. That matches the unsharded loop's arithmetic
        up to one rounding of the carry."""
        group = self.mesh.get_group(TIME_AXIS)
        ti = mesh_coords(self.mesh)[0]
        local = _ema_scan(x, alpha, w)
        P = torch.prod(1.0 - alpha * w, dim=0)
        Y = local[-1] if x.shape[0] else torch.zeros_like(P)
        pair = torch.stack([P.to(x.dtype), Y.to(x.dtype)])
        bufs = [torch.empty_like(comm_tensor(pair, group)) for _ in range(self.mesh.size(0))]
        dist.all_gather(bufs, comm_tensor(pair, group), group=group)
        carry = torch.zeros_like(Y)
        for buf in bufs[:ti]:
            Pj, Yj = from_comm_tensor(buf, pair)
            carry = Pj * carry + Yj
        return _ema_scan(x, alpha, w, y0=carry) if ti else local


def make_auto_sharded_align(cfg: PipelineConfig, mesh, smoothing: str = "global"):
    """Offline align over a (time, channel) mesh with the unsharded
    engine's numbers for BOTH smoothers: ``align_offline`` itself on each
    rank's slab, with the exchange the JAX package leaves to GSPMD written
    out. Each time shard but the first prepends the previous shard's last
    block (so the first shard has no zero-halo window to drop), the global
    sums are ``all_reduce``s on the time group, and the EMA carries across
    the shards (``_ShardedTime.ema``). Takes every backend: with
    ``pallas`` it runs the four-step kernel, with ``fused`` the i8 kernels.

    Input (this rank's shard): sig_u8 ``[T_loc, N_loc, L, 2]`` (or flat
    ``[T_loc, N_loc, 2L]``) u8; ref_u8 ``[T_loc, L, 2]`` (or ``[T_loc,
    2L]``). Returns this rank's ``OfflineResult``: windows (t - 1, t) of its
    blocks, T_loc - 1 on time shard 0 (which needs T_loc >= 2) and T_loc on
    the others, so the gathered outputs are the unsharded engine's T - 1.
    """
    time = _ShardedTime(mesh)

    def run(sig_u8: torch.Tensor, ref_u8: torch.Tensor):
        first = mesh_coords(mesh)[0] == 0
        if first and sig_u8.shape[0] < 2:
            raise ValueError("time shard 0 needs at least 2 blocks (one window)")
        prev_sig, prev_ref = _halo_prev_block((sig_u8, ref_u8), mesh)
        if not first:
            sig_u8 = torch.cat([prev_sig[None], sig_u8])
            ref_u8 = torch.cat([prev_ref[None], ref_u8])
        return align_offline(cfg, sig_u8, ref_u8, smoothing=smoothing, time=time)

    return run


_PER_CHANNEL = ("delay", "phase", "lag", "mag", "papr", "synced", "hist", "last_seq", "gaps")


def shard_state(state: PipelineState, mesh) -> PipelineState:
    """This rank's part of a streaming state over the channel axis (the
    JAX package's ``state_partition_spec``): per-channel leaves sliced on
    dim 0; the reference history and the block index replicated."""
    sl = channel_slice(mesh, state.delay.shape[0])
    return dataclasses.replace(state, **{f: getattr(state, f)[sl] for f in _PER_CHANNEL})


def make_sharded_step(cfg: PipelineConfig, mesh):
    """Streaming step sharded over the ``channel`` axis (the online path:
    one block at a time, channels split across ranks, reference
    replicated). Each rank runs ``step`` on its channel slice with
    ``n_channels = N // channel`` and every other field of ``cfg``.

    ``run(state, sig_u8, ref_u8, update_gate, seq=None) -> (state, out)``
    takes this rank's state (``shard_state``), its blocks ``[N_loc, L, 2]``
    (or flat ``[N_loc, 2L]``), the whole reference block and its seqnums
    ``[N_loc]``; the per-channel DSP is collective-free.
    """
    n_sh = mesh_shape(mesh)[1]
    if cfg.n_channels % n_sh:
        raise ValueError(f"n_channels={cfg.n_channels} not divisible by channel shards={n_sh}")
    local_cfg = dataclasses.replace(cfg, n_channels=cfg.n_channels // n_sh)

    def run(state, sig_u8, ref_u8, update_gate, seq=None):
        return step(local_cfg, state, sig_u8, ref_u8, update_gate, seq=seq)

    return run

