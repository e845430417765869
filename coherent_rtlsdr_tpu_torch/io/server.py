"""The streaming server (port of ``coherent_rtlsdr_tpu/io/server.py``):
source -> pipeline step -> ZMQ publish, with the console / remote control
plane, as one deterministic loop.

Loop per batch of blocks:
  1. pull the next block(s) from the source (numpy, host memory);
  2. pad them to the runner's width, stage them in pinned host memory and
     upload them without blocking;
  3. run the packed step (one block) or the packed scan runner (K blocks)
     of ``pipeline/drivers.py`` on the device;
  4. hand the outputs to the publisher worker, which copies them to the
     host on a side stream and publishes the frames on :5555 / :5557;
  5. drain the control socket and apply console commands;
  6. at most 4 times a second, hand the applied delays to the hardware
     drift relief (``io/hwcontrol.py``) when one is attached.

The state is carried on the device as the packed triple of
``pipeline/state.pack_state``; the ``state`` property is its host view.
Calibration persists across restarts (``save_state`` / ``restore_state``,
the JAX package's npz layout).

On a (1, S) channel mesh of ``torch.distributed`` ranks (``mesh=``, the
process group's rank 0) the loop is the same: step 3 runs
``parallel/sharded.py:make_sharded_server_runners``, which scatters the
blocks over the ranks and gathers their outputs, and every read or write
of the state is one collective operation in loop order. Only this rank
touches the source, the sockets and the checkpoint; the other ranks run
``serve_follower`` until ``close()``. Hot-plug on a mesh needs
``max_channels``.

The publisher is the native C++ packetizer (``native.py``) where it
builds and finds libzmq, else pyzmq's ``FramePublisher``.
"""

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch import constants
from coherent_rtlsdr_tpu_torch.io.console import ConsoleDispatcher
from coherent_rtlsdr_tpu_torch.parallel.sharded import make_sharded_server_runners
from coherent_rtlsdr_tpu_torch.pipeline.drivers import make_packed_scan_runner, make_packed_step
from coherent_rtlsdr_tpu_torch.pipeline.state import (
    PPACK_COLS,
    TELEMETRY_COLS,
    PipelineConfig,
    PipelineState,
    init_state,
    pack_state,
    pack_state_host,
    state_to_numpy,
    unpack_state_host,
)
from coherent_rtlsdr_tpu_torch.utils.telemetry import TelemetryRecorder

logger = logging.getLogger("coherent_rtlsdr_tpu_torch")

# packed-telemetry column index map (pipeline/state.TELEMETRY_COLS order)
_TCOL = {name: j for j, name in enumerate(TELEMETRY_COLS)}


class _LogRing(logging.Handler):
    """Captures the package's log records into the console ``log``
    command's drain list."""

    def __init__(self, lines: list, maxlen: int = 1000):
        super().__init__(level=logging.INFO)
        self._lines = lines
        self._maxlen = maxlen

    def emit(self, record: logging.LogRecord) -> None:
        self._lines.append(self.format(record))
        if len(self._lines) > self._maxlen:
            del self._lines[: len(self._lines) - self._maxlen]


def _os_picks_port(addr: str) -> bool:
    """A TCP address whose port the OS picks at bind time (``:*``, ``:!``)."""
    return addr.startswith("tcp://") and addr.rsplit(":", 1)[-1] in ("*", "!")


def _make_publisher(data_addr: str, debug_addr: str, header: bool):
    """The native C++ packetizer and publisher (frame assembly and send in
    C++, outside the interpreter lock), else pyzmq's ``FramePublisher``.
    pyzmq is chosen only when the native library has no compiler to build
    it, when it cannot load libzmq, or for an address whose port the OS
    picks (only pyzmq's sockets report the bound port back). A failed build
    or a failed bind raises."""
    from coherent_rtlsdr_tpu_torch import native

    if _os_picks_port(data_addr) or _os_picks_port(debug_addr):
        logger.info("publisher: pyzmq (the OS picks the port of %s / %s)", data_addr,
                    debug_addr)
    else:
        try:
            pub = native.NativePublisher(data_addr.replace("*", "0.0.0.0"),
                                         debug_addr.replace("*", "0.0.0.0"), header=header)
            logger.info("publisher: native (%s, debug %s)", data_addr, debug_addr)
            return pub
        except (native.NativeUnavailable, native.LibzmqUnavailable) as e:
            logger.info("publisher: pyzmq (%s)", e)
    from coherent_rtlsdr_tpu_torch.io.zmq_edge import FramePublisher

    return FramePublisher(data_addr=data_addr, debug_addr=debug_addr, header=header)


class CoherentServer:
    def __init__(
        self,
        cfg: PipelineConfig,
        source,
        fcenter: float = constants.DEFAULT_FCENTER,
        data_addr: str = "tcp://*:5555",
        ctrl_addr: str = "tcp://*:5556",
        debug_addr: str = "tcp://*:5557",
        header: bool = True,
        refnoise_enabled: bool = True,
        state_path: Optional[str] = None,
        publisher=None,
        control=None,
        scan_depth: int = 1,
        max_channels: Optional[int] = None,
        mesh=None,
        device="cuda",
    ):
        # Hot-plug without a new runner: with ``max_channels`` set, the
        # runners process a fixed [max_channels] width and console add/del
        # only move rows. Inactive rows carry u8 128 (zero) blocks and are
        # sliced off every frame, status and telemetry view.
        self.n_active = cfg.n_channels
        self.max_channels = max_channels
        if max_channels is not None:
            if max_channels < cfg.n_channels:
                raise ValueError("max_channels < n_channels")
            cfg = dataclasses.replace(cfg, n_channels=max_channels)
        self.device = torch.device(device)
        self.mesh = mesh
        self._shards = None
        self.scan_depth = int(scan_depth)
        self.n_runner_builds = 0
        # On a mesh: checks it, and posts the config to the other ranks.
        self._build_runners(cfg)
        if mesh is None:
            self._st = pack_state(init_state(cfg, self.device))   # raises without a card
            self._stage_device = self.device
        else:
            self._st = self._shards.init_pstate()   # this rank's channel rows
            self._stage_device = self._shards.comm_device
        # The publisher worker copies outputs to the host on its own stream,
        # so the fetch of batch k overlaps the dispatch of batch k+1.
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self._blocks_done = 0
        self.source = source
        self.fs = cfg.fs
        self.fcenter = fcenter
        self.refnoise_enabled = refnoise_enabled
        self.state_path = state_path
        self._do_exit = False
        self._resync_requested = False
        self._log_lines = []
        self._log_handler = _LogRing(self._log_lines)
        self._log_handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(self._log_handler)
        logger.setLevel(logging.INFO)
        self.telemetry = TelemetryRecorder()
        self._local_lines = None  # stdin queue when interactive (start_local_console)
        # optional io.hwcontrol.HwDriftRelief (rtlsdr source): ticked from
        # the loop with the applied delays, at most every 0.25 s
        self.hw_relief = None
        self._hw_relief_next = 0.0

        if publisher is None:
            publisher = _make_publisher(data_addr, debug_addr, header)
        if control is None:
            from coherent_rtlsdr_tpu_torch.io.zmq_edge import ControlServer

            control = ControlServer(ctrl_addr)
        self.publisher = publisher
        self.control = control
        self.dispatcher = ConsoleDispatcher(self)

        # The fused path takes flat [N, 2L] bytes, the generic one [N, L, 2].
        self._flat = cfg.fft_impl == "fused"
        if state_path and os.path.exists(state_path):
            self.restore_state(state_path)

    # ---- pipeline state storage -----------------------------------------
    # The loop carries the packed triple (ppack, ipack, hist) on the device;
    # `state` is the PipelineState view with numpy leaves for the rare host
    # touchpoints (status, checkpoint, hot-plug, tests): reading it fetches
    # the three tensors, assigning it packs and uploads them. On a mesh
    # `_st` is this rank's channel rows, and the view gathers every rank's.

    @property
    def state(self) -> PipelineState:
        st = self._st if self._shards is None else self._shards.get_state(self._st)
        return unpack_state_host(*st)

    @state.setter
    def state(self, s: PipelineState) -> None:
        if self._shards is None:
            self._st = pack_state_host(s, self.device)
        else:
            self._st = self._shards.set_state(self._st, pack_state_host(s, "cpu"))

    def _delays_host(self) -> np.ndarray:
        """The applied per-channel delays: one column of the small packed
        tensor, fetched (and waited for) alone."""
        if self._shards is not None:
            return self._shards.get_delays(self._st)
        return self._st[0][:, PPACK_COLS.index("delay")].cpu().numpy()

    def _block_idx_host(self) -> int:
        return int(self._st[1][0, 3].item())

    def capture_stderr(self) -> None:
        """-q mode: redirect OS-level stderr (fd 2) into the console ``log``
        drain, native writes from other threads included."""
        r, w = os.pipe()
        self._stderr_saved = os.dup(2)
        os.dup2(w, 2)
        os.close(w)

        def drain():
            with os.fdopen(r, "r", errors="replace") as f:
                for line in f:
                    line = line.rstrip()
                    if line:
                        self._log_lines.append(line)
                        if len(self._log_lines) > 1000:
                            del self._log_lines[: len(self._log_lines) - 1000]

        threading.Thread(target=drain, daemon=True).start()

    def _build_runners(self, cfg: PipelineConfig) -> None:
        """The packed step, and the packed scan runner when scan_depth > 1
        (``n_runner_builds`` counts the builds: a padded hot-plug makes
        none); on a mesh, every rank's."""
        self.cfg = cfg
        self.n_runner_builds += 1
        if self.mesh is None:
            self._step = make_packed_step(cfg)
            self._scan = make_packed_scan_runner(cfg) if self.scan_depth > 1 else None
            return
        if self._shards is None:
            self._shards = make_sharded_server_runners(cfg, self.mesh, self.scan_depth,
                                                       self.device)
        else:
            self._shards.rebuild(cfg)
        self._step, self._scan = self._shards.step, self._shards.scan

    # ---- staging (channel padding, host -> device) -----------------------

    def _stage(self, blocks):
        """Pad source blocks to the runner width and upload them: returns
        ``(sigs, refs, seqs)`` stacked over the blocks on the device. Pad
        rows get u8 128 (zero) samples and contiguous synthetic seqnums,
        advancing by one a block of the batch, so they never show a gap.
        On the card the bytes go through pinned host buffers and upload
        without blocking; PyTorch's pinned allocator hands a freed buffer
        out again only after the copy that reads it has run. On a mesh of
        ranks that share a card (gloo) they stay on the host: each rank
        uploads its own channels after the scatter."""
        K, n_jit, L = len(blocks), self.cfg.n_channels, self.cfg.block_len
        pin = self.device.type == "cuda"
        sig_shape = (K, n_jit, 2 * L) if self._flat else (K, n_jit, L, 2)
        sigs = torch.empty(sig_shape, dtype=torch.uint8, pin_memory=pin)
        refs = torch.empty(sig_shape[:1] + sig_shape[2:], dtype=torch.uint8, pin_memory=pin)
        seqs = torch.empty((K, n_jit), dtype=torch.int64, pin_memory=pin)
        s, r, q = sigs.numpy(), refs.numpy(), seqs.numpy()
        for i, (sig_u8, ref_u8, seqnums) in enumerate(blocks):
            n = sig_u8.shape[0]
            s[i, :n] = sig_u8.reshape((n,) + s.shape[2:])
            s[i, n:] = 128
            r[i] = ref_u8.reshape(r.shape[1:])
            q[i, :n] = seqnums
            q[i, n:] = (self._blocks_done + i + 1) & 0xFFFFFFFF
        return tuple(t.to(self._stage_device, non_blocking=True) for t in (sigs, refs, seqs))

    def _outputs_ready(self):
        """An event after the outputs just dispatched (None on the CPU)."""
        if self._copy_stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _fetch(self, ready, *tensors):
        """The tensors as numpy arrays. On the card, copies on the side
        stream after ``ready`` into pinned buffers; the caller holds the
        device tensors until this returns, so their memory is not reused
        while the copy reads it."""
        if ready is None:
            return [t.numpy() for t in tensors]
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        return [h.numpy() for h in host]

    # ---- channel hot-plug (console add/del) ------------------------------

    def _resize_channels(self, row_map) -> None:
        """Re-map channel rows for a new channel set. ``row_map[i]`` is the
        old row feeding new row i, or -1 for a fresh (unsynced) channel.
        Surviving channels keep their calibration: no re-sync.

        With ``max_channels`` set the runner width never changes: rows move
        on the host and the same runners keep running. Otherwise the config,
        the state and the runners are rebuilt."""
        old_state = self.state
        padded = self.max_channels is not None
        if padded:
            new_cfg = self.cfg
            full_map = list(row_map) + [-1] * (self.cfg.n_channels - len(row_map))
        else:
            new_cfg = dataclasses.replace(self.cfg, n_channels=len(row_map))
            full_map = list(row_map)
        new_state = state_to_numpy(init_state(new_cfg, "cpu"))
        for name in ("delay", "phase", "lag", "mag", "papr", "synced", "hist",
                     "last_seq", "gaps"):
            old_leaf = getattr(old_state, name)
            for newi, oldi in enumerate(full_map):
                if 0 <= oldi < old_leaf.shape[0]:
                    new_state[name][newi] = old_leaf[oldi]
        new_state.update(ref_hist=old_state.ref_hist, block_idx=old_state.block_idx)
        self.state = PipelineState(**new_state)
        self.n_active = len(row_map)
        # per-channel telemetry series change width across a resize
        self.telemetry.clear()
        if not padded:
            self._build_runners(new_cfg)

    # ---- calibration checkpoint / resume ---------------------------------

    def save_state(self, path: Optional[str] = None) -> None:
        """Persist calibration (delays, phases, sync) so that a restart
        needs no re-sync. (The history buffers are transient.)"""
        path = path or self.state_path
        if not path:
            return
        s = self.state
        np.savez(
            path,
            delay=s.delay,
            phase_iq=s.phase,  # [N, 2] float pairs
            synced=s.synced,
            block_idx=np.asarray(s.block_idx),
            fs=np.float64(self.fs),
            fcenter=np.float64(self.fcenter),
        )

    def restore_state(self, path: str) -> None:
        z = np.load(path)
        self.state = dataclasses.replace(
            self.state,
            delay=z["delay"],
            phase=z["phase_iq"].astype(np.float32),
            synced=z["synced"],
            block_idx=z["block_idx"],
        )
        self.fs = float(z["fs"])
        self.fcenter = float(z["fcenter"])

    # ---- main loop -------------------------------------------------------

    def run(self, max_blocks: Optional[int] = None) -> int:
        """Returns the number of blocks published.

        With ``scan_depth > 1`` the loop gathers that many source blocks and
        runs them through one call of the packed scan runner.

        Publishing is pipelined: a worker thread fetches batch k's outputs
        and publishes its frames while the main thread gathers, uploads and
        dispatches batch k+1 (the reference's double-buffered packetizer).
        One worker draining a FIFO queue keeps the frame order; the queue
        bound (2) caps the batches resident on the device.
        """
        # ref-channel wire seqnum base: the blocks processed so far, fetched
        # once a run (a fetch per frame would wait on the dispatch in flight)
        base = self._block_idx_host()
        pubq: queue.Queue = queue.Queue(maxsize=2)
        pub_err = []
        published = [0]

        def pub_worker():
            while True:
                item = pubq.get()
                if item is None:
                    return
                try:
                    published[0] += self._publish_batch(**item)
                except Exception as e:
                    pub_err.append(e)
                    return

        worker = threading.Thread(target=pub_worker, name="publisher", daemon=True)
        worker.start()

        def qput(item) -> bool:
            # bounded put that cannot deadlock against a worker that died
            # mid-publish (its error is raised after the loop)
            while not pub_err:
                try:
                    pubq.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        dispatched = 0
        gate_cache = (None, None)
        try:
            while not self._do_exit and not pub_err:
                if max_blocks is not None and dispatched >= max_blocks:
                    break

                if self._resync_requested:
                    s = self.state
                    self.state = dataclasses.replace(s, synced=np.zeros_like(s.synced))
                    self._resync_requested = False

                # one device bool tensor per gate value: the step then
                # copies nothing for it (on a mesh the bool itself, which
                # travels in the control header)
                if gate_cache[0] != self.refnoise_enabled:
                    v = self.refnoise_enabled
                    gate_cache = (v, v if self._shards is not None
                                  else torch.tensor(v, device=self.device))
                gate = gate_cache[1]
                k = 1
                if self._scan is not None:
                    k = self.scan_depth
                    if max_blocks is not None:
                        k = min(k, max_blocks - dispatched)
                blocks = []
                for _ in range(k):
                    blk = self.source.next_block()
                    if blk is None:
                        break
                    blocks.append(blk)
                if not blocks:
                    break

                na = self.n_active
                n_jit = self.cfg.n_channels
                if self._scan is not None and len(blocks) > 1:
                    sigs, refs, seqs = self._stage(blocks)
                    self._st, (wire_sigs, wire_refs), telem = self._scan(
                        self._st, sigs, refs, gate, seqs)
                    if not qput(dict(
                        wire_sigs=wire_sigs, wire_refs=wire_refs, telem=telem,
                        ready=self._outputs_ready(), seqnums=[b[2] for b in blocks],
                        na=na, base=base, n_jit=n_jit, L=self.cfg.block_len,
                    )):
                        break
                else:
                    enqueued = 0
                    for j, blk in enumerate(blocks):
                        sig, ref, seq = self._stage([blk])
                        self._st, wire_sig, wire_ref, telem = self._step(
                            self._st, sig[0], ref[0], gate, seq[0])
                        if not qput(dict(
                            wire_sigs=wire_sig, wire_refs=wire_ref, telem=telem,
                            ready=self._outputs_ready(), seqnums=[blk[2]], na=na,
                            base=base + j, n_jit=n_jit, L=self.cfg.block_len,
                        )):
                            break
                        enqueued += 1
                    if enqueued < len(blocks):
                        # publisher died mid-batch: count only what was
                        # enqueued, then leave on pub_err
                        base += enqueued
                        dispatched += enqueued
                        self._blocks_done += enqueued
                        break
                base += len(blocks)
                dispatched += len(blocks)
                self._blocks_done += len(blocks)
                self._poll_control()
                if self.hw_relief is not None:
                    # the host view of delay waits for the dispatch in
                    # flight, so 4 Hz at most (the relief acts over seconds)
                    now = time.monotonic()
                    if now >= self._hw_relief_next:
                        self._hw_relief_next = now + 0.25
                        self.hw_relief.tick(self._delays_host()[: self.n_active])
        finally:
            if pub_err:
                pubq.queue.clear()  # the worker is gone; nothing drains these
            pubq.put(None)
            worker.join()
            # runs even when the loop died (device error, source exception):
            # skewed dongles are restored, and a crash must not cost the
            # array its calibration
            if self.hw_relief is not None:
                try:
                    self.hw_relief.stop()
                except Exception:
                    logger.exception("dongle restore failed on exit")
            if self.state_path:
                try:
                    self.save_state()
                except Exception:
                    logger.exception("calibration save failed on exit")
        if pub_err:
            raise pub_err[0]
        return published[0]

    def _publish_batch(self, wire_sigs, wire_refs, telem, ready, seqnums, na, base,
                       n_jit, L) -> int:
        """Fetch one dispatched batch's outputs and publish every frame
        (runs on the publisher worker). Frame layout: channel 0 is the
        reference; the phases go out on the debug port. ``telem`` is the
        packed [.., N, 10] tensor (state.TELEMETRY_COLS). Returns the
        frames published."""
        T = len(seqnums)
        ws, wr, tp = self._fetch(ready, wire_sigs, wire_refs, telem)
        ws = ws.reshape(T, n_jit, L, 2)
        wr = wr.reshape(T, L, 2)
        tp = tp.reshape(T, n_jit, len(_TCOL))
        col = _TCOL
        for i, seq in enumerate(seqnums):
            frame = np.concatenate([wr[i][None], ws[i][:na]], axis=0)
            ref_seq = np.asarray([base + i + 1], np.uint32)
            all_seq = np.concatenate([ref_seq, seq.astype(np.uint32)])
            phases = np.concatenate([
                np.ones(1, np.complex64),
                (tp[i, :na, col["phase_re"]]
                 + 1j * tp[i, :na, col["phase_im"]]).astype(np.complex64),
            ])
            self.publisher.publish(frame, all_seq, phases)
            self._record_block(
                phases[1:], tp[i, :na, col["lag"]], tp[i, :na, col["residual"]],
                tp[i, :na, col["mag"]], tp[i, :na, col["gap"]] > 0,
                block_idx=base + i + 1,
            )
        return T

    def _record_block(self, phases, lag, residual, mag, gap, block_idx: int = -1) -> None:
        """Per-block observability: the telemetry ring and gap-event log
        lines. Runs on the publisher worker; must not touch self.state (a
        fetch there would wait on the dispatch in flight)."""
        self.telemetry.record(phase=phases, lag=lag, residual=residual, mag=mag)
        if gap.any():
            chans = np.nonzero(gap)[0]
            logger.warning("seqnum gap on channel(s) %s at block %d — desynced",
                           ",".join(str(int(c)) for c in chans), block_idx)

    def _poll_control(self) -> None:
        """Drain the remote control socket and, when interactive, the local
        stdin console."""
        self.control.poll(self.dispatcher.dispatch)
        q = self._local_lines
        if q is not None:
            while True:
                try:
                    line = q.get_nowait()
                except queue.Empty:
                    break
                try:
                    out = self.dispatcher.dispatch(line)
                except Exception as e:  # never kill the loop on a command
                    out = f"error: {e}"
                if out:
                    print(out, flush=True)

    # ---- console controller protocol ------------------------------------

    def get_fs(self):
        return self.fs

    def set_fs(self, v):
        """Retune the sample rate: rebuild the runners on the new config,
        push the rate to the source and force a full resync. Calibration
        survives; only the sync flags drop."""
        old_fs = self.fs
        if hasattr(self.source, "set_fs"):
            rc = self.source.set_fs(float(v))
            if rc is not None and rc != 0:
                # a receiver refused: put every healthy one back on the old
                # rate (mixed-rate arrays are incoherent) and keep the config
                logger.warning("source fs change to %.0f failed (rc=%s); restoring %.0f",
                               float(v), rc, old_fs)
                self.source.set_fs(old_fs)
                self.request_sync()
                return False
        self.fs = float(v)
        self.cfg = dataclasses.replace(self.cfg, fs=float(v))
        self._build_runners(self.cfg)
        self.request_sync()
        return True

    def get_fcenter(self):
        return self.fcenter

    def set_fcenter(self, v):
        if hasattr(self.source, "set_fcenter"):
            rc = self.source.set_fcenter(v)
            if rc is not None and rc != 0:
                logger.warning("source retune to %.0f failed (rc=%s); restoring %.0f",
                               float(v), rc, self.fcenter)
                self.source.set_fcenter(self.fcenter)
                return False
        self.fcenter = v
        return True

    def status(self) -> str:
        s = self.state
        na = self.n_active
        synced = s.synced[:na]
        lag = s.lag[:na]
        mag = s.mag[:na]
        gaps = s.gaps[:na]
        lines = [f"{int(synced.sum())} / {len(synced)} synchronized"]
        lines.append("Reference noise ENABLED." if self.refnoise_enabled
                     else "Reference noise DISABLED.")
        t = self.telemetry
        bps = t.timer.blocks_per_s()
        if bps == bps:  # not NaN
            lines.append(
                f"blocks/s: {bps:.1f}  mean block latency: "
                f"{t.timer.mean_dt * 1e3:.2f} ms  "
                f"throughput: {bps * len(synced) * self.cfg.block_len / 1e6:.3g} Msamp/s")
        drift = t.phase_drift_deg_rms()
        if drift == drift:
            lines.append(f"phase drift: {drift:.2f} deg RMS over "
                         f"{t.n_recorded('phase')} blocks")
        lines.append(f"seqnum gaps: {int(gaps.sum())} total")
        cap = getattr(self.source, "capture", None)
        if cap is not None:  # rtlsdr source: the native capture's health counters
            lines.append(f"capture: {'RUNNING' if cap.running else 'STOPPED'}  "
                         f"frames {cap.pushed}  chan-drops {cap.dropped}  stalls {cap.stalls}")
        cells = [f"ch{i}:{lag[i]:+4.3f}:{mag[i]:4.3f}" for i in range(len(synced))]
        for i in range(0, len(cells), 6):  # 6 devices per line
            lines.append("\t".join(cells[i: i + 6]))
        return "\n".join(lines)

    def list_channels(self, all=False) -> str:
        """``list`` = capturing channels; ``list all`` adds their serials
        and, when librtlsdr is loaded, the USB dongle inventory."""
        n = self.n_active
        lines = [f"{n} signal channels + ref"]
        serials = getattr(self.source, "serials", None)
        if serials and all:
            lines[0] += ":"
            lines += [f"  ch{i + 1}: '{s}'" for i, s in enumerate(serials)]
        if all:
            from coherent_rtlsdr_tpu_torch import native

            if native.available() and native.rtlsdr_available():
                inv = native.rtlsdr_enumerate()
                lines.append(f"USB inventory ({len(inv)} dongles):")
                lines += [f"  #{i}: '{s}'" for i, s in enumerate(inv)]
        return "\n".join(lines)

    def phase_table(self) -> str:
        p = self.state.phase[: self.n_active]
        ph = np.degrees(np.angle((p[..., 0] + 1j * p[..., 1]).astype(np.complex64)))
        return "\t".join(str(int(x)) for x in ph)

    def set_refnoise(self, v: bool):
        self.refnoise_enabled = bool(v)
        if hasattr(self.source, "refnoise_enabled"):
            self.source.refnoise_enabled = bool(v)

    def request_lag(self):
        """``request lag`` is a no-op by design: every channel's lag is
        measured every block."""
        return "lag is measured on every channel every block; nothing to force"

    def request_sync(self):
        self._resync_requested = True

    def add_channel(self, serial: str) -> str:
        if not hasattr(self.source, "add_channel"):
            return "add not supported for this source"
        old_n = self.n_active
        if self.max_channels is not None and old_n + 1 > self.max_channels:
            return f"channel limit reached ({self.max_channels})"
        if self.mesh is not None and self.max_channels is None:
            return "add with a device mesh requires --max-channels"
        try:
            idx = self.source.add_channel(serial)
        except RuntimeError as e:  # a hardware open failed
            return str(e)
        self._resize_channels(list(range(old_n)) + [-1])
        return f"added '{serial}' as channel {idx + 1}"  # wire ch 0 = ref

    def del_channel(self, serial: str) -> str:
        if not hasattr(self.source, "del_channel"):
            return "del not supported for this source"
        if self.mesh is not None and self.max_channels is None:
            return "del with a device mesh requires --max-channels"
        old_n = self.n_active
        i = self.source.del_channel(serial)
        if i is None:
            return f"no such channel: '{serial}'"
        self._resize_channels([r for r in range(old_n) if r != i])
        return f"deleted '{serial}'"

    def drain_log(self) -> str:
        out = "\n".join(self._log_lines)
        del self._log_lines[:]  # keep the handler's list identity
        return out

    def start_local_console(self, stream=None) -> None:
        """Local interactive console: a stdin reader thread feeding the same
        dispatcher as the remote socket; the loop drains its lines."""
        import sys

        stream = stream or sys.stdin
        q = queue.Queue()
        self._local_lines = q

        def reader():
            if stream is sys.stdin and sys.stdin.isatty():
                try:
                    import readline  # noqa: F401  (line editing for input())
                except ImportError:
                    pass
                while True:
                    try:
                        line = input("> ")
                    except EOFError:
                        return
                    q.put(line)
                    if line.strip() == "quit":
                        return
            else:
                for line in stream:
                    q.put(line.rstrip("\n"))
                    if line.strip() == "quit":
                        return

        threading.Thread(target=reader, daemon=True, name="local-console").start()

    def request_exit(self):
        """Signal-safe: leave the loop after the current iteration (run()
        then saves the state and returns normally)."""
        self._do_exit = True

    def shutdown(self):
        self._do_exit = True
        logger.removeHandler(self._log_handler)

    def close(self) -> None:
        """On a mesh, release the other ranks (they return from
        ``serve_follower``): call once, after the last ``run()``, whose
        exit has saved the checkpoint."""
        if self._shards is not None:
            self._shards.close()
