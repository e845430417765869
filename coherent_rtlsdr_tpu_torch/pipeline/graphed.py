"""The depth-1 packed step replayed as one CUDA graph.

On the card, one call of the packed step (``drivers.make_packed_step``:
unpack, the seqnum gap check, XOR, ``measure_ref`` + ``measure_i8_spec``,
the control law, the phase EMA, ``apply_spec_i8``, the reference
passthrough, the telemetry, pack) is ~90 small device operations, each a
few microseconds of work behind tens of microseconds of Python and ATen
dispatch. Its shapes are fixed by the configuration, it reads no value back
to the host, and the hand-written kernels launch on PyTorch's current
stream (``kernels/fused_cuda.py:_setup``), so one call is captured once
(``torch.cuda.CUDAGraph``) and replayed every block: the same kernels on
the same bytes in the same order, so wire bytes, telemetry and state are
bit-equal to the eager step's.

The streaming server's runners wrap their depth-1 step in
:class:`GraphedStep` on the card, on the fused path, without a mesh
(``io/server.py:LocalServerRunners``, ``step_is_graphed``).
"""

import collections

import torch

from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
from coherent_rtlsdr_tpu_torch.utils.telemetry import SPANS

# Calls of the wrapped runner on scratch copies before the capture: the
# first builds the kernels' tables and lets ``tc::persistent_grid`` set its
# kernel attributes, so that the capture records launches alone.
WARMUP_CALLS = 3


class GraphedStep:
    """``run(pstate, sig, ref, gate, seq) -> (pstate, wire, wire_ref,
    telem)`` over ``runner``, a packed step of that signature for ``cfg``
    on ``device`` (a card), replayed as one CUDA graph.

    A call is a function of its arguments, as the eager step's is: it
    writes none of them, and what it returns (the new packed state, wire,
    wire_ref, telem) are clones of the graph's buffers, which no later call
    writes. So a caller may hold any state or output it was given, pass any
    state in (the server's own, a replaced one, a checkpoint's), and the
    server's worker may copy a block's outputs to the host on its own
    stream while the loop replays the next block (the caching allocator
    hands a clone's memory out again only after the worker drops it).

    It owns static device buffers: the packed state (ppack, ipack, hist),
    the block's inputs (sig, ref, seq) and a 0-d bool gate. The first call
    copies its arguments into new buffers, warms the runner up on scratch
    copies on a side stream, and captures one call of it, which ends by
    copying the new state into the state buffers; then it replays. Each
    later call copies the block's inputs in, the state unless it is the
    one the last call returned (whose values the state buffers still
    hold), and the gate when its tensor changes (the server makes one
    tensor a gate value); then it replays and clones.

    Launch counts keep meaning launches a block served: the kernels'
    counts (``FusedPipelineKernels.counts``) are put back after the warm-up
    and the capture, and each replay adds what the captured call launched.
    ``counts`` (a ``collections.Counter``, shared by the server's runners
    across their builds) gets ``"captures"`` and ``"replays"``. When
    ``utils.SPANS`` is recording, each replay is the span
    ``kernels.step_graph``; the step's own ``step.*`` and ``kernels.<op>``
    spans run only in the warm-up and the capture.
    """

    def __init__(self, runner, cfg, device, counts=None):
        self._runner = runner
        self._fft_len = 2 * cfg.block_len
        self.device = torch.device(device)
        self.counts = collections.Counter() if counts is None else counts
        self._state = None    # (ppack, ipack, hist)
        self._inputs = None   # (sig, ref, seq)
        self._gate = None
        self._gate_src = None
        self._last = None     # the state the last call returned
        self._graph = None
        self._kernels = None  # the FusedPipelineKernels whose launches it counts
        self._outs = None     # the graph's (wire, wire_ref, telem)
        self._launches = {}   # kernel count name -> launches a replay

    def __call__(self, pstate, sig, ref, gate, seq):
        if self._graph is None:
            self._state = tuple(t.clone() for t in pstate)
            self._inputs = tuple(t.clone() for t in (sig, ref, seq))
            self._set_gate(gate)
            self._capture()
        else:
            if pstate is not self._last:
                for dst, src in zip(self._state, pstate):
                    dst.copy_(src)
            for dst, src in zip(self._inputs, (sig, ref, seq)):
                dst.copy_(src)
            if gate is not self._gate_src:
                self._set_gate(gate)
        with SPANS.span("kernels.step_graph"):
            self._graph.replay()
        self._last = tuple(t.clone() for t in self._state)
        wire, wire_ref, telem = (t.clone() for t in self._outs)
        k = self._kernels
        for name, n in self._launches.items():
            setattr(k, name, getattr(k, name) + n)
        self.counts["replays"] += 1
        return self._last, wire, wire_ref, telem

    def _set_gate(self, gate) -> None:
        g = torch.as_tensor(gate, dtype=torch.bool, device=self.device)
        if self._gate is None:
            self._gate = g.clone()
        else:
            self._gate.copy_(g)
        self._gate_src = gate   # held, so that its identity cannot be reused

    def _body(self) -> None:
        """One call of the runner on the static buffers: the captured work."""
        sig, ref, seq = self._inputs
        st, wire, wire_ref, telem = self._runner(self._state, sig, ref, self._gate, seq)
        for dst, src in zip(self._state, st):
            dst.copy_(src)   # none where the runner hands its state back
        self._outs = (wire, wire_ref, telem)

    def _capture(self) -> None:
        self._kernels = k = get_fused_kernels(self._fft_len, self.device)
        saved = k.counts()
        try:
            self._warm_up()
            before = k.counts()
            self._graph = self._graph_of(self._body)
            after = k.counts()
        finally:
            for name, n in saved.items():
                setattr(k, name, n)
        self._launches = {name: after[name] - before[name] for name in after
                          if after[name] != before[name]}
        self.counts["captures"] += 1

    def _warm_up(self) -> None:
        """The runner on scratch copies of the static state, on a side
        stream ordered after the static buffers' copies."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        sig, ref, seq = self._inputs
        with torch.cuda.stream(side):
            scratch = tuple(t.clone() for t in self._state)
            for _ in range(WARMUP_CALLS):
                scratch = self._runner(scratch, sig, ref, self._gate, seq)[0]
        main.wait_stream(side)

    def _graph_of(self, body):
        graph = torch.cuda.CUDAGraph()
        # thread_local: after a runner rebuild the capture runs while the
        # server's publisher worker may still be fetching earlier blocks
        # (pinned allocations, event waits on its own stream), which the
        # global mode would refuse.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
        return graph
