"""Block-stream drivers around ``step`` (port of
``coherent_rtlsdr_tpu/pipeline/drivers.py``).

* ``make_scan_runner``: K blocks per call, the state as a ``PipelineState``.
* ``make_packed_scan_runner``: K blocks per call with the state packed to
  three tensors (``state.pack_state``) - the streaming server's mode.
* ``make_packed_step``: its single-block twin.
* ``run_capture``: a whole in-memory capture with streaming semantics.

The fused path emits int8 wire bytes straight from its apply kernel (flat
``[N, 2L]``); the generic path quantizes the aligned complex blocks with
``c64_to_i8_iq`` (``[N, L, 2]``), as the JAX package does. The JAX package
scans with ``lax.scan`` inside one jitted program; here the scan is a
Python loop over the blocks.
"""

from typing import Tuple

import torch

from coherent_rtlsdr_tpu_torch.ops.convert import c2f, c64_to_i8_iq
from coherent_rtlsdr_tpu_torch.pipeline.state import (
    SEQ_MASK,
    BlockOutput,
    PipelineConfig,
    PipelineState,
    Telemetry,
    pack_state,
    pack_telemetry,
    stack_telemetry,
    unpack_state,
)
from coherent_rtlsdr_tpu_torch.pipeline.step import as_seq, step


def _wire(out: BlockOutput):
    """The block's int8 payload (wire, wire_ref)."""
    if out.wire is not None:
        return out.wire, out.wire_ref
    return c64_to_i8_iq(out.aligned), c64_to_i8_iq(out.ref)


def _scan(cfg, state, sigs, refs, gate, seqs, payload):
    """``step`` over the leading axis: returns (state, payload stacked over
    the blocks as a pair, [Telemetry per block])."""
    firsts, seconds, telems = [], [], []
    for i in range(sigs.shape[0]):
        state, out = step(cfg, state, sigs[i], refs[i], gate,
                          seq=None if seqs is None else seqs[i])
        a, b = payload(out)
        firsts.append(a)
        seconds.append(b)
        telems.append(out.telemetry)
    return state, (torch.stack(firsts), torch.stack(seconds)), telems


def make_scan_runner(cfg: PipelineConfig, emit_wire: bool = True, pack_telem: bool = False):
    """Returns ``run(state, sigs [K,N,L,2], refs [K,L,2], gate, seqs=None)
    -> (state, payload, telem)``: the payload stacked over K is the int8
    wire pair when ``emit_wire``, else the aligned blocks as float32 (re,
    im) pairs; telemetry is stacked ``Telemetry``, or one ``[K, N, 10]``
    tensor when ``pack_telem``. ``seqs`` ``[K, N]`` enables gap detection;
    without it the seqnums continue from the state's."""

    def payload(out):
        return _wire(out) if emit_wire else (c2f(out.aligned), c2f(out.ref))

    def run(state, sigs, refs, gate, seqs=None):
        if seqs is None:
            k = torch.arange(1, sigs.shape[0] + 1, device=state.last_seq.device)
            seqs = (state.last_seq[None, :] + k[:, None]) & SEQ_MASK
        state, pay, telems = _scan(cfg, state, sigs, refs, gate, seqs, payload)
        telem = (torch.stack([pack_telemetry(t) for t in telems]) if pack_telem
                 else stack_telemetry(telems))
        return state, pay, telem

    return run


def make_packed_scan_runner(cfg: PipelineConfig):
    """Returns ``run(pstate, sigs [K,N,2L|K,N,L,2], refs [K,2L|K,L,2], gate,
    seqs [K,N]) -> (pstate, (wire, wire_ref), telem [K,N,10])`` with
    ``pstate = (ppack, ipack, hist)``."""

    def run(pstate, sigs, refs, gate, seqs):
        state = unpack_state(*pstate)
        seqs = as_seq(seqs, state.last_seq.device)
        state, pay, telems = _scan(cfg, state, sigs, refs, gate, seqs, _wire)
        return pack_state(state), pay, torch.stack([pack_telemetry(t) for t in telems])

    return run


def make_packed_step(cfg: PipelineConfig):
    """Single-block twin of :func:`make_packed_scan_runner`: ``run(pstate,
    sig, ref, gate, seq) -> (pstate, wire, wire_ref, telem [N, 10])``."""

    def run(pstate, sig_u8, ref_u8, gate, seq):
        state, out = step(cfg, unpack_state(*pstate), sig_u8, ref_u8, gate, seq=seq)
        wire, wire_ref = _wire(out)
        return pack_state(state), wire, wire_ref, pack_telemetry(out.telemetry)

    return run


def run_capture(
    cfg: PipelineConfig,
    state: PipelineState,
    sig_u8: torch.Tensor,  # [T, N, L, 2] or [T, N, 2L]
    ref_u8: torch.Tensor,  # [T, L, 2] or [T, 2L]
    gate: bool = True,
) -> Tuple[PipelineState, torch.Tensor, torch.Tensor, Telemetry]:
    """Streaming-exact processing of a whole capture: returns (state, wire,
    wire_ref, Telemetry stacked over T); the wire is ``[T, N, 2L]`` on the
    fused path and ``[T, N, L, 2]`` on the generic path."""
    state, (wire, wire_ref), telem = make_scan_runner(cfg)(state, sig_u8, ref_u8, gate)
    return state, wire, wire_ref, telem
