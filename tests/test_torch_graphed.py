"""The server's depth-1 step replayed as one CUDA graph
(``pipeline/graphed.py``, ``io/server.py:step_is_graphed``).

On the CPU: the rule that picks the graphed step (the card, the fused path,
no mesh, and nothing else), a CPU server's eager step (no graph, its frames
those of ``make_packed_step`` driven by hand), and ``GraphedStep``'s own
bookkeeping (a function of its arguments, launch counts, the counters)
with a stand-in for the capture that runs the captured call again on each
replay. On the card (marked ``cuda``, skipped without one): the graphed
server against the eager one at N = 21, L = 8192 through the same
scenario, every frame bit-equal, and direct calls of its step that leave
the served state alone.

The file imports neither JAX nor the JAX package, so on a machine without
them it runs as ``python -m pytest --noconftest tests/test_torch_graphed.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu_torch.io import server as server_mod
from coherent_rtlsdr_tpu_torch.io.server import CoherentServer, step_is_graphed
from coherent_rtlsdr_tpu_torch.io.streamio import Capture
from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, init_state, make_packed_step
from coherent_rtlsdr_tpu_torch.pipeline import graphed
from coherent_rtlsdr_tpu_torch.pipeline.graphed import GraphedStep
from coherent_rtlsdr_tpu_torch.pipeline.state import pack_state
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture
from coherent_rtlsdr_tpu_torch.signal.sources import FileSource, SyntheticStreamSource

KERNELS = ("measure_ref", "measure_spec", "apply_spec_i8")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


class _Publisher:
    def __init__(self):
        self.frames = []

    def publish(self, iq_i8, seqnums, phases=None):
        self.frames.append((np.array(iq_i8), np.array(seqnums), np.array(phases)))
        return iq_i8.size


class _Control:
    def __init__(self):
        self.queue = []

    def poll(self, handler, timeout_ms=0):
        n = 0
        while self.queue:
            handler(self.queue.pop(0))
            n += 1
        return n


def _cfg(n, L, impl="fused"):
    return PipelineConfig(n_channels=n, block_len=L, fft_impl=impl,
                          lag_method="phase_zoom" if impl == "fused" else "phase_slope")


# ---- the rule ----------------------------------------------------------------

@pytest.mark.parametrize("device, impl, want", [
    ("cuda", "fused", True),
    ("cuda:0", "fused", True),
    (torch.device("cuda", 1), "fused", True),
    ("cpu", "fused", False),
    ("cuda", "xla", False),
    ("cuda", "mxu", False),
    ("cuda", "pallas", False),
    ("cuda", "auto", False),
    ("cpu", "xla", False),
])
def test_step_is_graphed_exactly_on_the_card_fused_without_a_mesh(device, impl, want):
    assert step_is_graphed(_cfg(3, 2048, impl), device) is want


# ---- a CPU server: no graph ---------------------------------------------------

@pytest.mark.parametrize("scan_depth", [1, 3])
def test_cpu_server_builds_no_graph(scan_depth):
    """A fused server on the CPU keeps the eager step: no graph captured or
    replayed, and every frame bit-equal to ``make_packed_step`` driven by
    hand over the same blocks."""
    n, L, T = 3, 2048, 9
    truth = make_truth(n, seed=3, max_delay=20.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(3), truth, T, L)
    seqs = np.tile(np.arange(1, T + 1, dtype=np.uint32)[:, None], (1, n))
    seqs[5:, 1] += 1   # a seqnum gap on channel 1
    cfg = _cfg(n, L)
    pub = _Publisher()
    srv = CoherentServer(cfg, FileSource(Capture(sig_u8=cap.sig_u8.numpy(),
                                                 ref_u8=cap.ref_u8.numpy(), seqnums=seqs,
                                                 fs=2.048e6, fcenter=868e6)),
                         publisher=pub, control=_Control(), scan_depth=scan_depth, device="cpu")
    assert not isinstance(srv._runners._step, GraphedStep)
    assert srv.run() == T
    assert srv.graph_captures == 0 and srv.graph_replays == 0
    step = make_packed_step(cfg)
    st = pack_state(init_state(cfg, "cpu"))
    gate = torch.tensor(True)
    for t, (iq, s, _) in enumerate(pub.frames):
        st, wire, wire_ref, _ = step(st, cap.sig_u8[t].reshape(n, 2 * L),
                                     cap.ref_u8[t].reshape(2 * L), gate,
                                     torch.from_numpy(seqs[t].astype(np.int64)))
        want = torch.cat([wire_ref.reshape(1, L, 2), wire.reshape(n, L, 2)]).numpy()
        np.testing.assert_array_equal(iq, want)
        np.testing.assert_array_equal(s[1:], seqs[t])
    assert srv.state.gaps[1] == 1


# ---- the scenario: the graphed server against the eager one -------------------

def _server(dev, n, L, **kw):
    """A fused server on a synthetic stream with block drops (seqnum
    gaps)."""
    truth = make_truth(n, seed=21, max_delay=40.0, snr_db=30.0)
    src = SyntheticStreamSource(truth, block_len=L, slab_blocks=16, seed=21, drop_rate=0.2 / n,
                                device=dev)
    pub, ctl = _Publisher(), _Control()
    return CoherentServer(_cfg(n, L), src, publisher=pub, control=ctl, device=dev, **kw), pub, ctl


# Blocks a run() of the scenario: 72 in all.
SCENARIO_BLOCKS = (16, 8, 8, 8, 8, 16, 8)


def _serve(srv, ctl, blocks):
    """One run() a step, ``blocks`` blocks each: the refnoise gate switched
    off and on, the state replaced mid-stream (a resync with a delay jump),
    a console resync, a hot-plugged channel, then more blocks. Returns the
    blocks served."""
    served = 0

    def run(cmds, k):
        nonlocal served
        ctl.queue += cmds
        assert srv.run(max_blocks=k) == k
        served += k

    run([], blocks[0])
    run(["request rd"], blocks[1])
    run(["request re"], blocks[2])
    s = srv.state
    srv.state = dataclasses.replace(s, synced=np.zeros_like(s.synced), delay=s.delay + 0.5)
    run([], blocks[3])
    run(["request sync"], blocks[4])
    run(["add NEWCH"], blocks[5])
    run([], blocks[6])
    return served


def _assert_same_stream(a, b):
    (asrv, apub), (bsrv, bpub) = a, b
    assert len(apub.frames) == len(bpub.frames) > 0
    for (aiq, aseq, aph), (biq, bseq, bph) in zip(apub.frames, bpub.frames):
        assert aiq.shape == biq.shape and aiq.dtype == biq.dtype == np.int8
        np.testing.assert_array_equal(aiq, biq)
        np.testing.assert_array_equal(aseq, bseq)
        np.testing.assert_array_equal(aph.view(np.uint32), bph.view(np.uint32))
    sa, sb = asrv.state, bsrv.state
    for f in dataclasses.fields(sa):
        x, y = getattr(sa, f.name), getattr(sb, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(np.atleast_1d(x).view(np.uint8),
                                      np.atleast_1d(y).view(np.uint8), err_msg=f.name)


def _check_graphed_against_eager(dev, n, L, blocks, monkeypatch, counted, **kw):
    """The scenario served by the eager server (the rule patched off for
    all of its runner builds), then by the graphed one (on the CPU, the
    rule patched on): the same stream, a replay a block, and one launch (on
    the CPU, one plain run) of each fused kernel a block."""
    with monkeypatch.context() as m:
        m.setattr(server_mod, "step_is_graphed", lambda *a: False)
        eager, epub, ectl = _server(dev, n, L, **kw)
        _serve(eager, ectl, blocks)
    assert eager.graph_captures == 0 and eager.graph_replays == 0
    k = get_fused_kernels(2 * L, dev)
    k.reset_counts()
    with monkeypatch.context() as m:
        if torch.device(dev).type == "cpu":
            m.setattr(server_mod, "step_is_graphed", lambda *a: True)
        srv, pub, ctl = _server(dev, n, L, **kw)
        assert isinstance(srv._runners._step, GraphedStep)
        served = _serve(srv, ctl, blocks)
    _assert_same_stream((srv, pub), (eager, epub))
    assert srv.graph_replays == served
    assert k.counts() == dict.fromkeys(k.counts(), 0) | {
        f"{name}_{counted}": served for name in KERNELS}
    before_plug = np.stack([seq for _, seq, _ in pub.frames[:sum(blocks[:5])]])[:, 1:]
    assert (np.diff(before_plug.astype(np.int64), axis=0) > 1).any(), "no seqnum gap served"
    return srv


class _EagerGraph:
    """A stand-in for a captured graph on the CPU: a replay runs the
    captured call again on the static buffers, and, as a graph's replay
    runs no wrapper, leaves the kernels' counts as they were."""

    def __init__(self, step, body):
        self.step, self.body = step, body

    def replay(self):
        k = self.step._kernels
        saved = k.counts()
        self.body()
        for name, n in saved.items():
            setattr(k, name, n)


def _graph_of_on_cpu(self, body):
    saved = [t.clone() for t in self._state]
    body()   # the capture's one call, whose launches the capture counts
    for dst, src in zip(self._state, saved):
        dst.copy_(src)   # a capture runs nothing
    return _EagerGraph(self, body)


def _warm_up_on_cpu(self):
    sig, ref, seq = self._inputs
    scratch = tuple(t.clone() for t in self._state)
    for _ in range(graphed.WARMUP_CALLS):
        scratch = self._runner(scratch, sig, ref, self._gate, seq)[0]


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    monkeypatch.setattr(GraphedStep, "_graph_of", _graph_of_on_cpu)
    monkeypatch.setattr(GraphedStep, "_warm_up", _warm_up_on_cpu)




def test_graphed_step_bookkeeping_on_cpu(graphs_on_cpu, monkeypatch):
    """``GraphedStep`` with replays that run the captured call again: the
    served stream bit-equal to the eager server's through gaps, the gate
    off and on, a replaced state, a console resync and a padded hot-plug;
    one capture over seven run() calls, a replay and one run of each plain
    kernel a block served, none for the warm-up or the capture."""
    srv = _check_graphed_against_eager("cpu", 3, 2048, SCENARIO_BLOCKS, monkeypatch, "plain_runs",
                                       max_channels=5)
    assert srv.graph_captures == 1 and srv.n_runner_builds == 1


def test_graphed_step_captures_again_after_a_rebuild_on_cpu(graphs_on_cpu, monkeypatch):
    """A hot-plug without ``max_channels`` rebuilds the runners, and the new
    step captures a graph of its own at its first block."""
    srv = _check_graphed_against_eager("cpu", 3, 2048, SCENARIO_BLOCKS, monkeypatch, "plain_runs")
    assert srv.n_runner_builds == 2 and srv.graph_captures == 2
    assert srv.cfg.n_channels == 4


def test_graphed_step_copies_in_only_what_changed_on_cpu(graphs_on_cpu):
    """Direct calls against the eager step on the same blocks: the first
    captures (its warm-up moves neither state nor outputs); each call's
    state and outputs equal the eager step's, whether the state passed in
    is the one the last call returned (not copied in), a replaced one, or
    an older one after that (both copied in); no call writes its arguments or what an earlier call
    returned, and no state returned is the step's own buffer."""
    n, L = 3, 2048
    cfg = _cfg(n, L)
    eager = make_packed_step(cfg)
    truth = make_truth(n, seed=5, max_delay=20.0, snr_db=30.0)
    cap = synth_capture(torch.Generator().manual_seed(5), truth, 3, L)
    sig, ref = cap.sig_u8.reshape(3, n, 2 * L), cap.ref_u8.reshape(3, 2 * L)
    seq = torch.arange(1, 4, dtype=torch.int64)[:, None].expand(3, n).contiguous()
    on, off = torch.tensor(True), torch.tensor(False)
    st0 = pack_state(init_state(cfg, "cpu"))
    want, states, st = [], [], st0
    for t, gate in enumerate((on, on, off)):
        st, *o = eager(st, sig[t], ref[t], gate, seq[t])
        want.append(o)
        states.append(st)
    after = eager(states[2], sig[1], ref[1], on, seq[1])
    args = [t.clone() for t in (*st0, sig, ref, seq)]

    def same(got, expect):
        assert len(got) == len(expect)
        for a, b in zip(got, expect):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                same(a, b)

    g = GraphedStep(eager, cfg, "cpu")
    got = []
    for t, (p, gate) in enumerate(((st0, on), (None, on), (None, off))):
        p, *o = g(got[-1][0] if p is None else p, sig[t], ref[t], gate, seq[t])
        same(p, states[t])
        same(o, want[t])
        assert not any(a.data_ptr() == b.data_ptr() for a in p for b in g._state)
        got.append((p, *o))
    assert g.counts == {"captures": 1, "replays": 3}
    p, *o = g(st0, sig[0], ref[0], on, seq[0])   # a replaced state, the gate back on
    same(p, states[0])
    same(o, want[0])
    p, *o = g(got[2][0], sig[1], ref[1], on, seq[1])   # an older state again
    same((p, *o), after)
    for (p, *o), st, w in zip(got, states, want):
        same(p, st)
        same(o, w)
    same((*st0, sig, ref, seq), args)
    assert g.counts == {"captures": 1, "replays": 5}


def _a_block(n, L):
    rng = np.random.default_rng(7)
    return (rng.integers(0, 256, (n, 2 * L), dtype=np.uint8),
            rng.integers(0, 256, 2 * L, dtype=np.uint8), np.arange(100, 100 + n, dtype=np.uint32))


def _check_direct_calls_leave_the_server_alone(dev, n, L, whose, monkeypatch):
    """Eight blocks served, three direct one-block calls of the server's
    runners (its step) on ``whose`` state ("own": the server's, "another": a fresh one), then
    eight more: the server's state is as it was after the calls, and its
    16 frames and final state bit-equal to an eager server's that served 16
    blocks without them."""
    with monkeypatch.context() as m:
        m.setattr(server_mod, "step_is_graphed", lambda *a: False)
        eager, epub, _ = _server(dev, n, L)
        assert eager.run(max_blocks=16) == 16
    with monkeypatch.context() as m:
        if torch.device(dev).type == "cpu":
            m.setattr(server_mod, "step_is_graphed", lambda *a: True)
        srv, pub, _ = _server(dev, n, L)
    assert isinstance(srv._runners._step, GraphedStep)
    assert srv.run(max_blocks=8) == 8
    held = srv.state
    pstate = srv._st if whose == "own" else pack_state(init_state(srv.cfg, dev))
    sig, ref, seq = srv._stage([_a_block(n, L)])
    for _ in range(3):
        srv._runners.run(pstate, sig, ref, True, seq)
    now = srv.state
    for f in dataclasses.fields(held):
        np.testing.assert_array_equal(getattr(now, f.name), getattr(held, f.name), err_msg=f.name)
    assert srv.run(max_blocks=8) == 8
    _assert_same_stream((srv, pub), (eager, epub))
    assert srv.graph_captures == 1 and srv.graph_replays == 16 + 3


@pytest.mark.parametrize("whose", ["own", "another"])
def test_direct_step_calls_leave_the_server_state_alone_on_cpu(graphs_on_cpu, monkeypatch, whose):
    _check_direct_calls_leave_the_server_alone("cpu", 3, 2048, whose, monkeypatch)


# ---- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_graphed_server_matches_eager_on_card(cuda_device, monkeypatch):
    """N = 21, L = 8192, 72 blocks on the card: the graphed server's frames
    (bytes, phases, seqnums) and final state bit-equal to the eager
    server's through seqnum gaps, the refnoise gate off and on, a replaced
    state, a console resync and a padded hot-plug (``max_channels`` 24);
    one capture over seven run() calls, one replay and one launch of each
    fused kernel a block served."""
    srv = _check_graphed_against_eager(cuda_device, 21, 8192, SCENARIO_BLOCKS, monkeypatch,
                                       "launches", max_channels=24)
    assert srv.graph_captures == 1 and srv.n_runner_builds == 1


@pytest.mark.cuda
def test_graphed_server_captures_again_after_a_rebuild_on_card(cuda_device, monkeypatch):
    """A hot-plug without ``max_channels`` on the card: the runners are
    rebuilt at 22 channels, the new step captures a second graph, and the
    stream stays bit-equal to the eager server's."""
    srv = _check_graphed_against_eager(cuda_device, 21, 8192, SCENARIO_BLOCKS, monkeypatch,
                                       "launches")
    assert srv.n_runner_builds == 2 and srv.graph_captures == 2
    assert srv.cfg.n_channels == 22


@pytest.mark.cuda
@pytest.mark.parametrize("whose", ["own", "another"])
def test_direct_step_calls_leave_the_server_state_alone_on_card(cuda_device, monkeypatch, whose):
    """Direct calls of the graphed step on the server's own state or on
    another one, between two runs on the card, N = 21, L = 8192: the
    served state does not move, and the stream stays bit-equal to an eager
    server's that had no such calls."""
    _check_direct_calls_leave_the_server_alone(cuda_device, 21, 8192, whose, monkeypatch)
