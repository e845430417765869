"""Block-stream drivers around ``step`` (port of
``coherent_rtlsdr_tpu/pipeline/drivers.py``, fused payloads).

* ``make_packed_scan_runner``: K blocks per call with the state packed to
  three tensors (``state.pack_state``) - the streaming server's mode.
* ``make_packed_step``: its single-block twin.
* ``run_capture``: a whole in-memory capture with streaming semantics.

The JAX package scans with ``lax.scan`` inside one jitted program; here the
scan is a Python loop over the blocks.
"""

from typing import Tuple

import torch

from coherent_rtlsdr_tpu_torch.pipeline.state import (
    PipelineConfig,
    PipelineState,
    Telemetry,
    pack_state,
    pack_telemetry,
    stack_telemetry,
    unpack_state,
)
from coherent_rtlsdr_tpu_torch.pipeline.step import as_seq, step


def _scan(cfg, state, sigs, refs, gate, seqs):
    """``step`` over the leading axis: returns (state, wire [K, N, 2L],
    wire_ref [K, 2L], [Telemetry per block])."""
    wires, wire_refs, telems = [], [], []
    for i in range(sigs.shape[0]):
        state, out = step(cfg, state, sigs[i], refs[i], gate,
                          seq=None if seqs is None else seqs[i])
        wires.append(out.wire)
        wire_refs.append(out.wire_ref)
        telems.append(out.telemetry)
    return state, torch.stack(wires), torch.stack(wire_refs), telems


def make_packed_scan_runner(cfg: PipelineConfig):
    """Returns ``run(pstate, sigs [K,N,2L|K,N,L,2], refs [K,2L|K,L,2], gate,
    seqs [K,N]) -> (pstate, (wire, wire_ref), telem [K,N,10])`` with
    ``pstate = (ppack, ipack, hist)``."""

    def run(pstate, sigs, refs, gate, seqs):
        state = unpack_state(*pstate)
        seqs = as_seq(seqs, state.last_seq.device)
        state, wire, wire_ref, telems = _scan(cfg, state, sigs, refs, gate, seqs)
        return (pack_state(state), (wire, wire_ref),
                torch.stack([pack_telemetry(t) for t in telems]))

    return run


def make_packed_step(cfg: PipelineConfig):
    """Single-block twin of :func:`make_packed_scan_runner`: ``run(pstate,
    sig, ref, gate, seq) -> (pstate, wire, wire_ref, telem [N, 10])``."""

    def run(pstate, sig_u8, ref_u8, gate, seq):
        state, out = step(cfg, unpack_state(*pstate), sig_u8, ref_u8, gate, seq=seq)
        return pack_state(state), out.wire, out.wire_ref, pack_telemetry(out.telemetry)

    return run


def run_capture(
    cfg: PipelineConfig,
    state: PipelineState,
    sig_u8: torch.Tensor,  # [T, N, L, 2] or [T, N, 2L]
    ref_u8: torch.Tensor,  # [T, L, 2] or [T, 2L]
    gate: bool = True,
) -> Tuple[PipelineState, torch.Tensor, torch.Tensor, Telemetry]:
    """Streaming-exact processing of a whole capture: returns (state, wire
    [T, N, 2L], wire_ref [T, 2L], Telemetry stacked over T)."""
    state, wire, wire_ref, telems = _scan(cfg, state, sig_u8, ref_u8, gate, None)
    return state, wire, wire_ref, stack_telemetry(telems)
