"""The offline align engines, the streaming step and the streaming server's
runners over a (time, channel) mesh (port of
``coherent_rtlsdr_tpu/parallel/sharded.py``).

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

Channel shards never communicate. The server's runners
(``make_sharded_server_runners``) move each batch of blocks between rank 0,
which owns the source and the publisher, and the channel shards: see
:class:`ShardedServerRunners`.
"""

import dataclasses
import json
import math

import torch
import torch.distributed as dist

from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
from coherent_rtlsdr_tpu_torch.ops.convert import c64_to_i8_iq, u8_to_c64, u8_to_i8
from coherent_rtlsdr_tpu_torch.ops.delay import apply_delay_phase_freq
from coherent_rtlsdr_tpu_torch.ops.phase import phase_correction_estimate
from coherent_rtlsdr_tpu_torch.ops.xcorr import lag_estimate_from_spectra
from coherent_rtlsdr_tpu_torch.parallel.distributed import RANK_TIMEOUT
from coherent_rtlsdr_tpu_torch.parallel.mesh import (
    CHANNEL_AXIS,
    TIME_AXIS,
    channel_slice,
    comm_tensor,
    from_comm_tensor,
    mesh_coords,
    mesh_shape,
)
from coherent_rtlsdr_tpu_torch.pipeline.drivers import make_packed_scan_runner, make_packed_step
from coherent_rtlsdr_tpu_torch.pipeline.offline import TimeAxis, _ema_scan, align_offline
from coherent_rtlsdr_tpu_torch.pipeline.state import (
    PPACK_COLS,
    PipelineConfig,
    PipelineState,
    fused_m,
    init_state,
    pack_state,
)
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



# -- the streaming server over a channel mesh ---------------------------------

# Control headers: rank 0 broadcasts int64 [op, a, b] on the control group
# before the collectives of each operation.
_STEP = 1        # a = K blocks, b = the gate
_STATE_GET = 2   # a = 1: the delay column only
_STATE_SET = 3
_REBUILD = 4     # a = bytes of the config's JSON, broadcast next
_EXIT = 5
_HEADER_LEN = 3
_DELAY = PPACK_COLS.index("delay")
_ALIGN = 16      # bytes: each tensor's offset in a packed chunk


def _layout(specs):
    """Byte offsets of the tensors ``[(shape, dtype)]`` one after the
    other in a chunk of packed bytes, each at a multiple of _ALIGN, and
    the chunk's length."""
    offs, end = [], 0
    for shape, dtype in specs:
        offs.append(end)
        end += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return offs, end


def _bytes(buf, off, shape, dtype):
    """The ``dtype`` tensor of ``shape`` at byte ``off`` of the last axis
    of the uint8 ``buf`` (its leading axes kept): a view."""
    n = math.prod(shape) * dtype.itemsize
    return buf[..., off:off + n].view(dtype).view(*buf.shape[:-1], *shape)


def _check_server_mesh(cfg: PipelineConfig, shape) -> None:
    t, n_sh = shape
    if t != 1:
        raise ValueError(f"the streaming server shards channels only: it takes a (1, S) mesh, "
                         f"got ({t}, {n_sh})")
    if cfg.n_channels % n_sh:
        raise ValueError(f"n_channels={cfg.n_channels} not divisible by {n_sh} channel shards "
                         "(with --max-channels, pick a multiple of the mesh)")


class ShardedServerRunners:
    """One rank's part of the streaming server on a (1, S) channel mesh
    whose ranks are the whole process group, one rank a device (the
    counterpart of the JAX package's ``make_sharded_server_jits``).

    Rank 0 is the controller: it alone owns the source, staging, the
    publisher, the console and the checkpoint, and calls ``step`` /
    ``scan`` with the unsharded packed runners' signatures and global
    outputs. The other ranks run :func:`serve_follower`, which answers rank
    0's headers until it posts EXIT. Each operation is a control header
    (int64 ``[op, a, b]``, broadcast on a gloo group of the mesh's ranks, so
    a waiting rank waits on the CPU) and then its data collectives on the
    mesh's channel group (NCCL when each rank has a card, gloo with host
    copies when ranks share one or run on the CPU), issued in the same order
    on every rank:

      STEP (K, gate)  one scatter: each rank's chunk of packed bytes holds
                      its seqnums [K, N/S], its signal rows [K, N/S, ...]
                      and the reference block [K, ...]; each rank's packed
                      runner on its packed state; one gather to rank 0 of
                      each rank's packed telemetry [K, N/S, 10] and wire
                      [K, N/S, ...], put together in channel-rank order;
                      ``wire_ref`` is rank 0's own (every rank computes it)
      STATE_GET       the packed state's per-channel rows gathered (or the
                      delay column alone); hist row 0 and block_idx rank 0's
      STATE_SET       the rows scattered, hist row 0 broadcast
      REBUILD         the config broadcast as JSON; every rank rebuilds its
                      runners (``n_runner_builds`` counts on every rank)
      EXIT            the other ranks return

    The header is the only traffic beside the data: the hot loop has no
    other collective, as the JAX runners have none. Rank 0 does not wait
    for a header's broadcast: it waits for it when it posts the next one.
    """

    def __init__(self, mesh, device="cuda"):
        self.S = mesh_shape(mesh)[1]
        if dist.get_world_size() != self.S:
            raise ValueError(f"the server's mesh must cover the process group: {self.S} "
                             f"channel shards, {dist.get_world_size()} ranks")
        self.leader = mesh_coords(mesh)[1] == 0
        self.group = mesh.get_group(CHANNEL_AXIS)
        self._src = dist.get_global_rank(self.group, 0)
        self._ctl = dist.new_group(dist.get_process_group_ranks(self.group),
                                   timeout=RANK_TIMEOUT, backend="gloo")
        self._posted = None         # rank 0's last header broadcast
        self.device = torch.device(device)
        nccl = dist.get_backend(self.group) == "nccl"
        # Where rank 0 stages the global blocks and the collectives run.
        self.comm_device = self.device if nccl else torch.device("cpu")
        self._pin = not nccl and self.device.type == "cuda"
        self._gates = {v: torch.tensor(v, device=self.device) for v in (False, True)}
        self.local_cfg = None
        self.pstate = None          # a follower's packed state
        self.n_runner_builds = 0
        self.blocks_served = 0
        self.scan = None
        self._closed = False

    # ---- rank 0 -------------------------------------------------------------

    def step(self, pstate, sig_u8, ref_u8, gate: bool, seq):
        """One block, as ``make_packed_step``'s runner: ``(pstate, wire,
        wire_ref, telem [N, 10])``. ``pstate`` is rank 0's packed shard;
        ``gate`` a Python bool (it travels in the header)."""
        self._post(_STEP, 1, int(gate))
        pstate, wire, wire_ref, telem = self._run(pstate, 1, gate, sig_u8[None], ref_u8[None],
                                                  seq[None])
        return pstate, wire[0], wire_ref[0], telem[0]

    def scan_blocks(self, pstate, sigs, refs, gate: bool, seqs):
        """K blocks, as ``make_packed_scan_runner``'s runner: ``(pstate,
        (wire, wire_ref), telem [K, N, 10])``."""
        self._post(_STEP, sigs.shape[0], int(gate))
        pstate, wire, wire_ref, telem = self._run(pstate, sigs.shape[0], gate, sigs, refs, seqs)
        return pstate, (wire, wire_ref), telem

    def rebuild(self, cfg: PipelineConfig) -> None:
        """Build every rank's runners for the global ``cfg``."""
        _check_server_mesh(cfg, (1, self.S))
        data = torch.frombuffer(bytearray(json.dumps(dataclasses.asdict(cfg)).encode()),
                                dtype=torch.uint8)
        self._post(_REBUILD, data.numel())
        dist.broadcast(data, self._src, group=self._ctl)
        self._build(cfg)

    def init_pstate(self):
        """This rank's initial packed state."""
        return pack_state(init_state(self.local_cfg, self.device))

    def get_state(self, pstate):
        """The global packed state on the host, from rank 0's shard
        ``pstate`` and the others'."""
        self._post(_STATE_GET, 0)
        return self._gather_state(pstate)

    def get_delays(self, pstate):
        """The global delay column as a numpy array."""
        self._post(_STATE_GET, 1)
        return self._gather(pstate[0][:, _DELAY], 0).cpu().numpy()

    def set_state(self, pstate, global_pstate):
        """Scatter the global packed state (host tensors); returns rank 0's
        new shard in place of ``pstate``."""
        self._post(_STATE_SET)
        return self._scatter_state(pstate, global_pstate)

    def close(self) -> None:
        """Post EXIT: the other ranks return from :func:`serve_follower`."""
        if not self._closed:
            self._closed = True
            self._post(_EXIT)
            self._release()

    # ---- the other ranks ------------------------------------------------------

    def serve(self):
        """Answer rank 0's headers until EXIT; returns this object."""
        while True:
            head = torch.empty(_HEADER_LEN, dtype=torch.int64)
            dist.broadcast(head, self._src, group=self._ctl)
            op, a, b = head.tolist()
            if op == _STEP:
                self.pstate = self._run(self.pstate, a, bool(b))[0]
            elif op == _STATE_GET:
                if a:
                    self._gather(self.pstate[0][:, _DELAY], 0)
                else:
                    self._gather_state(self.pstate)
            elif op == _STATE_SET:
                self.pstate = self._scatter_state(self.pstate, None)
            elif op == _REBUILD:
                data = torch.empty(a, dtype=torch.uint8)
                dist.broadcast(data, self._src, group=self._ctl)
                self._build(PipelineConfig(**json.loads(bytes(data.numpy()))))
                if self.pstate is None:
                    self.pstate = self.init_pstate()
            elif op == _EXIT:
                self._release()
                return self
            else:
                raise RuntimeError(f"unknown control header {head.tolist()}")

    # ---- every rank -------------------------------------------------------------

    def _release(self) -> None:
        """Destroy the control group here and now, not at interpreter exit."""
        self._wait_posted()
        dist.destroy_process_group(self._ctl)
        self._ctl = None

    def _wait_posted(self) -> None:
        if self._posted is not None:
            self._posted, work = None, self._posted
            work.wait()

    def _post(self, op: int, a: int = 0, b: int = 0) -> None:
        """Broadcast a header without waiting for it (the broadcast holds
        its tensor); a failed one raises when the next is posted."""
        self._wait_posted()
        self._posted = dist.broadcast(torch.tensor([op, a, b], dtype=torch.int64), self._src,
                                      group=self._ctl, async_op=True)

    def _build(self, cfg: PipelineConfig) -> None:
        self.local_cfg = dataclasses.replace(cfg, n_channels=cfg.n_channels // self.S)
        self._step1 = make_packed_step(self.local_cfg)
        self._step_k = make_packed_scan_runner(self.local_cfg)
        L = cfg.block_len
        self._block_tail = (2 * L,) if cfg.fft_impl == "fused" else (L, 2)
        self.n_runner_builds += 1

    def _run(self, pstate, k, gate, sigs=None, refs=None, seqs=None):
        """K blocks through this rank's runner: rank 0 passes the global
        ``[K, N, ...]`` blocks, the others None. Returns (pstate, wire
        [K, N, ...] and telem [K, N, 10] on rank 0 or None, wire_ref)."""
        seq, sig, ref = self._scatter_blocks(k, seqs, sigs, refs)
        g = self._gates[bool(gate)]
        if k == 1:
            pstate, wire, wire_ref, telem = self._step1(pstate, sig[0], ref[0], g, seq[0])
            wire, wire_ref, telem = wire[None], wire_ref[None], telem[None]
        else:
            pstate, (wire, wire_ref), telem = self._step_k(pstate, sig, ref, g, seq)
        self.blocks_served += k
        telem, wire = self._gather_outputs(telem, wire)
        return pstate, wire, wire_ref, telem

    def _scatter_blocks(self, k, seqs, sigs, refs):
        """One scatter: rank r's chunk of packed bytes holds its seqnums
        and signal rows (channels r n .. (r + 1) n) and the reference
        block. Returns this rank's (seq, sig, ref) on its device."""
        n = self.local_cfg.n_channels
        ins = [((k, n), torch.int64), ((k, n, *self._block_tail), torch.uint8),
               ((k, *self._block_tail), torch.uint8)]
        offs, nbytes = _layout(ins)
        parts = None
        if self.leader:
            packed = torch.empty((self.S, nbytes), dtype=torch.uint8, device=self.comm_device)
            by_rank = [x.unflatten(1, (self.S, n)).movedim(1, 0) for x in (seqs, sigs)]
            # the reference block goes to every rank: copy_ broadcasts it
            for (shape, dtype), off, x in zip(ins, offs, (*by_rank, refs)):
                _bytes(packed, off, shape, dtype).copy_(x)
            parts = list(packed.unbind(0))
        chunk = self._empty((nbytes,), torch.uint8)
        dist.scatter(chunk, parts, self._src, group=self.group)
        chunk = chunk.to(self.device, non_blocking=True)
        return tuple(_bytes(chunk, off, shape, dtype) for (shape, dtype), off in zip(ins, offs))

    def _gather_outputs(self, *xs):
        """One gather: every rank's ``xs`` (each ``[K, n, ...]``) packed as
        bytes, put together on rank 0 as ``[K, S n, ...]`` each (views of
        the gathered bytes when S == 1); Nones elsewhere."""
        specs = [(tuple(x.shape), x.dtype) for x in xs]
        offs, nbytes = _layout(specs)
        out = self._empty((nbytes,), torch.uint8)
        for (shape, dtype), off, x in zip(specs, offs, xs):
            _bytes(out, off, shape, dtype).copy_(x)
        gathered = (torch.empty((self.S, nbytes), dtype=torch.uint8, device=self.comm_device)
                    if self.leader else None)
        dist.gather(out, None if gathered is None else list(gathered.unbind(0)), self._src,
                    group=self.group)
        if gathered is None:
            return (None,) * len(xs)
        return tuple(_bytes(gathered, off, shape, dtype).movedim(0, 1).flatten(1, 2)
                     for (shape, dtype), off in zip(specs, offs))

    def _empty(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, device=self.comm_device, pin_memory=self._pin)

    def _scatter(self, x, shape, dtype, dim):
        """Rank 0's ``x`` split in S along ``dim``: this rank's part (of
        ``shape``) on its device."""
        buf = self._empty(shape, dtype)
        parts = None
        if x is not None:
            parts = [p.contiguous()
                     for p in torch.tensor_split(x.to(self.comm_device), self.S, dim=dim)]
        dist.scatter(buf, parts, self._src, group=self.group)
        return buf.to(self.device, non_blocking=True)

    def _broadcast(self, x, shape, dtype):
        buf = self._empty(shape, dtype) if x is None else x.to(self.comm_device).contiguous()
        dist.broadcast(buf, self._src, group=self.group)
        return buf.to(self.device, non_blocking=True)

    def _gather(self, x, dim):
        """Every rank's ``x`` put together along ``dim`` on rank 0 (on the
        collectives' device); None elsewhere."""
        buf = x.to(self.comm_device).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.S)] if self.leader else None
        dist.gather(buf, parts, self._src, group=self.group)
        if parts is None:
            return None
        return parts[0] if self.S == 1 else torch.cat(parts, dim=dim)

    def _gather_state(self, pstate):
        ppack, ipack = self._gather(pstate[0], 0), self._gather(pstate[1], 0)
        rows = self._gather(pstate[2][1:], 0)
        if not self.leader:
            return None
        return ppack.cpu(), ipack.cpu(), torch.cat([pstate[2][:1].cpu(), rows.cpu()])

    def _scatter_state(self, pstate, global_pstate):
        ppack, ipack, hist = global_pstate or (None, None, None)
        ppack = self._scatter(ppack, pstate[0].shape, pstate[0].dtype, 0)
        ipack = self._scatter(ipack, pstate[1].shape, pstate[1].dtype, 0)
        ref_row = self._broadcast(None if hist is None else hist[:1], pstate[2][:1].shape,
                                  pstate[2].dtype)
        rows = self._scatter(None if hist is None else hist[1:], pstate[2][1:].shape,
                             pstate[2].dtype, 0)
        return ppack, ipack, torch.cat([ref_row, rows])


def make_sharded_server_runners(cfg: PipelineConfig, mesh, scan_depth: int = 1,
                                device="cuda"):
    """Rank 0's side of the streaming server sharded over the ``channel``
    axis of a (1, S) mesh: a :class:`ShardedServerRunners` whose ``step``
    and ``scan`` (None at depth 1) take and return what
    ``make_packed_step`` / ``make_packed_scan_runner`` do, on rank 0's
    packed shard (``init_pstate``). Posts the config to the other ranks,
    which run :func:`serve_follower`. Raises ``ValueError`` for a time axis
    larger than 1 and for a channel count S does not divide."""
    _check_server_mesh(cfg, mesh_shape(mesh))
    if mesh_coords(mesh)[1] != 0:
        raise ValueError("rank 0 runs the server; the other ranks call serve_follower")
    runners = ShardedServerRunners(mesh, device)
    runners.rebuild(cfg)
    runners.scan = runners.scan_blocks if scan_depth > 1 else None
    return runners


def serve_follower(mesh, device="cuda"):
    """A rank other than 0 of the sharded server: builds its runners from
    the config rank 0 posts, answers every header on its own packed shard,
    and returns its :class:`ShardedServerRunners` (``pstate``,
    ``n_runner_builds``, ``blocks_served``) when rank 0 posts EXIT."""
    if mesh_coords(mesh)[1] == 0:
        raise ValueError("rank 0 runs the server (make_sharded_server_runners)")
    return ShardedServerRunners(mesh, device).serve()
