"""The server driver: ``CoherentServer.run`` fed from the benchmark's own
source, publishing into the benchmark's own sink.

Traffic parameters (``traffic/<mix>.json``):

* ``scan_depth``: the server's blocks a call (1 is the app's default);
* ``period_samples``: the length of the periodic stream a channel, rendered
  on the card at set-up and replayed from host memory with seqnums that keep
  counting (P = period_samples / L blocks);
* ``warmup_blocks``: blocks served before the window;
* ``sample_share``: the share of the window's frames whose bytes the sink
  keeps for the comparison, drawn from the seed (phases and seqnums of every
  frame are compared).

The loop is closed: the source hands over the next block as soon as the
loop asks. The window ends ``--seconds`` after it starts: the source hands
over nothing after that, and the run waits for every frame still in
flight.
"""

import time

import numpy as np
import torch

from portbench import synth, wire
from portbench.drivers import pipeline_config
from portbench.reference import align, compare


class StreamSource:
    """The server's block source over one period ``sig [P, N, 2L]``, ``ref
    [P, 2L]`` (numpy uint8) of the periodic stream: block g of the stream is
    block g mod P, with seqnum g + 1 on every channel."""

    def __init__(self, sig: np.ndarray, ref: np.ndarray):
        self.sig, self.ref = sig, ref
        self.P, self.N = sig.shape[0], sig.shape[1]
        self.g = 0
        self.handoff = []     # host clock at each block's hand-over, by g
        self._stop = lambda g: True

    def serve_count(self, n: int) -> None:
        end = self.g + n
        self._stop = lambda g: g >= end

    def serve_window(self, t_end: float) -> None:
        self._stop = lambda g: time.perf_counter() >= t_end

    def next_block(self):
        g = self.g
        if self._stop(g):
            return None
        self.handoff.append(time.perf_counter())
        self.g += 1
        w = g % self.P
        return self.sig[w], self.ref[w], np.full(self.N, (g + 1) & 0xFFFFFFFF, np.uint32)


class Sink:
    """The server's publisher: serializes every frame and its phases in the
    wire format, stamps its receipt, and keeps the seqnums and phases of
    every frame and the bytes of the frames in ``keep``."""

    def __init__(self, keep):
        self.keep = keep
        self.recv, self.seqs, self.phases, self.kept = [], [], [], {}

    def publish(self, iq_i8, seqnums, phases=None):
        t = time.perf_counter()
        i = len(self.recv)
        buf = wire.pack_frame(i, seqnums, iq_i8)
        wire.pack_debug(phases)
        self.recv.append(t)
        self.seqs.append(np.array(seqnums, np.uint32))
        self.phases.append(np.array(phases[1:], np.complex64))
        if i in self.keep:
            self.kept[i] = buf
        return len(buf)


class ScriptedControl:
    """The server's control socket with no commands."""

    def poll(self, handler, timeout_ms=0):
        return 0


def sample_frames(seed: int, first: int, share: float, n_max: int = 1 << 20) -> set:
    rng = np.random.default_rng([seed, 0x5A17])
    idx = first + np.nonzero(rng.random(n_max) < share)[0]
    return {first} | set(idx.tolist())


def run(run):
    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer

    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    N, L = cfg["n_channels"], cfg["block_len"]
    P = tr["period_samples"] // L
    truth = synth.make_truth(N, seed=run.seed, max_delay=cfg["truth_max_delay"],
                             snr_db=cfg["snr_db"])
    sig, ref = synth.render_periodic(run.seed, truth, P, L, cfg["amplitude"], device=dev)
    host_sig = sig.reshape(P, N, 2 * L).cpu().numpy()
    host_ref = ref.reshape(P, 2 * L).cpu().numpy()
    del sig, ref
    run.reset_memory()
    run.mark("render")

    source = StreamSource(host_sig, host_ref)
    warm = tr["warmup_blocks"]
    sink = Sink(sample_frames(run.seed, warm, tr["sample_share"]))
    pcfg = pipeline_config(cfg)
    srv = CoherentServer(pcfg, source, publisher=sink, control=ScriptedControl(),
                         scan_depth=tr["scan_depth"], device=dev)
    run.mark("server")
    source.serve_count(warm)
    srv.run()
    run.sync()

    with run.window() as win:
        source.serve_window(win.t0 + run.seconds)
        srv.run()
        run.sync()
    run.read_memory()
    del srv

    # whole-window arithmetic: every block handed over in the window
    g0, g1 = warm, source.g
    recv = np.full(g1, np.inf)
    recv[: len(sink.recv)] = sink.recv[:g1]
    window = dict(blocks=g1 - g0, n_channels=N, block_len=L, t0=win.t0,
                  t_end=win.t0 + run.seconds, recv=recv[g0:g1],
                  handoff=np.asarray(source.handoff[g0:g1]))
    run.data.update(window)
    run.attempted = g1 - g0
    run.failed = int(np.sum(~np.isfinite(window["recv"])))

    # the comparison, on the card once the program is gone
    r = compare.Readings()
    r.count("missing_frames", g1 - len(sink.recv))
    want_seq = (np.arange(len(sink.seqs), dtype=np.int64) + 1) & 0xFFFFFFFF
    got_seq = np.stack(sink.seqs).astype(np.int64) if sink.seqs else np.zeros((0, N + 1))
    r.count("seq_errors", int(np.sum(np.any(got_seq != want_seq[:, None], axis=1)))
            + max(0, len(sink.seqs) - g1))
    ref_stream = align.StreamReference(
        align.Transform(2 * L, dev, "f64"), align.Params(cfg),
        torch.from_numpy(host_sig).to(dev).view(P, N, L, 2),
        torch.from_numpy(host_ref).to(dev).view(P, L, 2))
    ref_stream.follow(g1)
    n = min(len(sink.phases), g1)
    frames = {g: wire.unpack_frame(buf).iq for g, buf in sink.kept.items() if g < g1}
    compare.stream(r, ref_stream, np.stack(sink.phases[:n]) if n else [], frames)
    return r.values()
