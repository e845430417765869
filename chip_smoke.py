"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``coherent_rtlsdr_tpu_torch/csrc`` and drives
the port's paths at the production width (N = 21 channels, L = 8192,
W = 2L = 128^2), phase by phase. The fused i8 path (fft_impl="fused"):

  1. device, versions, kernel build;
  2. each i8 kernel (the reference-spectrum and channel halves of measure,
     and apply) against its plain PyTorch version, at m = 128 (N = 21,
     T = 5) and m = 64, on random and on synthetic correlated bytes;
  3. the offline engine ``align_offline`` at T = 256 blocks: samples/s, and
     the launch counts showing it ran through the kernels;
  4. quality against synthetic truth (residual phase and lag);
  5. the streaming runner ``make_packed_scan_runner`` at K = 32 for 4 calls,
     with launch counts, then each kernel against its plain version on the
     inputs one more streaming step gives it;
  6. each kernel against its plain version at the offline shapes, timed;
  7. one streaming call and one offline run under torch.profiler: device
     busy time, idle share and each fused kernel's device time.

The generic path (fft_impl="pallas", lag_method="phase_slope"; the
four-step FFT kernel) and ``FusedSpectral`` (the float measure/apply
kernels):

  8. the four-step kernel forward and inverse at m = 128 and 64 against its
     plain version and torch.fft, at B = 42 and at the batch sizes that
     exercise its persistent grid of one CTA an SM (1, SMs - 1, SMs + 1,
     3 SMs + 5), and the float measure/apply kernels against theirs at
     N = 21, on random and correlated planes, with advances of large
     integer part among the windows;
  9. the generic offline engine at T = 256: samples/s over >= 5 timed runs,
     peak memory, four-step launch counts; once with fft_impl="xla"
     (cuFFT) beside it;
 10. generic quality against synthetic truth;
 11. the generic streaming runner at K = 32 for 4 calls;
 12. ``FusedSpectral`` prepare -> measure -> correct at T = 256, by its
     launch counts, then timed over 3 more calls;
 13. the four-step kernel (B = 5,355 transforms) against its plain version
     and ``torch.fft``, timed over runs of launches, and the float
     measure/apply kernels against theirs, at the offline shapes, timed
     and once under torch.profiler for their device times.

The recompute i8 pair (``measure_i8`` -> ``apply_i8``) and the roofline
probe with its block copy:

 14. the recompute kernels against their plain versions at m = 128 (N = 21,
     T = 5) and m = 64, on random and correlated bytes; then the pair
     driven at the offline shapes (bytes -> measure_i8 -> advance = lag,
     phase factor conj(z)/|z| -> apply_i8), by its launch counts, held to
     the handoff pair (the JAX package's contract,
     tests/test_kernels.py:433-450) and timed against its plain versions;
 15. the roofline probe (``coherent_rtlsdr_tpu_torch.tools.probe_roofline``)
     at full size, by its launch counts, then the block copy held bit-equal
     to its input and timed against its plain version and ``x.clone()``,
     over runs of launches.

The streaming server (``io/server.py``), with an in-process recording
publisher (frames serialized in the wire format) and a scripted control
socket:

 16. a capture rendered on the card by ``synth_stream_slab`` and served by
     ``FileSource`` from host memory; the fused server at scan depth 1 and
     32: samples/s (frames x N x L over each timed window's wall clock,
     median of 3, against 43.0e6), one more window with the loop's host
     time split by part, the idle share of one depth-32 run under
     torch.profiler, 21 / 21 synced, contiguous ref seqnums, the last 16
     frames' contents (lag 0, corr >= 0.99, |phase| < 1 deg against
     channel 0), one launch of each fused kernel a block and no plain run,
     at depth 1 one CUDA graph of the step captured and replayed a block
     (``pipeline/graphed.py``), and the first frames bit-equal to
     ``make_packed_scan_runner``'s on the same bytes; console commands
     mid-run (status, phase, request rd / re, fcenter, an fs change that
     forces a resync) and padded hot-plug
     (max_channels = 24, add then del, no runner rebuilt) on a synthetic
     stream rendered on the card; a checkpoint restored into a new server
     that resumes synced with its ref seqnums continuing; the generic
     server (``pallas``, 64 blocks at scan depth 8, 2 + 2 four-step
     launches a block); Farrow on the card against the CPU.

The native host edge (``native.py`` over ``csrc/coherent_host.cc``, built
with g++ at first use) feeding the fused server:

 17. (a) the native library's build seconds, whether it loads libzmq and
     whether ``ldconfig -p`` lists ``libzmq.so.5``; (b) phase 16's capture
     continued to 2,286 blocks and written as raw ring blocks (ref first)
     to /dev/shm or the temp directory, deleted at the end; (c) a paced
     ``NativeProducer.file`` -> ``NativeBlockRing`` -> ``RingSource`` ->
     server chain at scan depth 1 and 32, 128 blocks each: no ring drops,
     the first 64 frames bit-equal to phase 16's on the same bytes, 21 / 21
     synced, phase 16's frame bars on the last 16, one launch of each
     fused kernel a block; (d) the producer paced at 250 blocks/s (21 ch x
     2.048 Msps) into a 256-slot ring, a 1,000-block timed window at each
     depth after a warm-up and a drain: samples/s, ring drops, the fill at
     the window's end and the loop's host time by part (``source`` is
     ``RingSource.next_block``); at depth 32 no drop and an end fill of at
     most 64 blocks (depth 1 is recorded, with no bar); (e) where libzmq
     loads, the depth-32 window again through ``NativePublisher`` on a
     loopback TCP port, read back by the port's ``NativeProducer.zmq``:
     the first 64 frames byte for byte against ``io/wire.pack_frame`` of
     the same outputs, and the worker's publish ms a block beside (d)'s
     in-process publisher's; (f) the mock librtlsdr
     (``tests/data/mock_librtlsdr.c``, built with gcc) behind ``RtlSource``,
     3 signal channels, 64 blocks at depth 1: each channel's seqnums
     contiguous, one launch of each fused kernel a block, and an
     ``HwDriftRelief`` pulse and its restore in the mock's call log.

The array models (``coherent_rtlsdr_tpu_torch/models``, no kernel of their
own: complex64 products and cuSOLVER's eigh / solve) and the MUSIC client
app, fed by the fused server:

 18. (a) on the 21 signal channels as the published 7x3 URA, T = 16 x 8192
     snapshots of two plane waves made on the card from a seeded generator:
     the steering matrix within 1e-5 and the covariance within 1e-5 of its
     largest entry of float64; ``music_heatmap``, ``bartlett_spectrum`` and
     ``mvdr_spectrum`` over the
     100 x 100 (u, v) grid, each within 0.1 dB of a float64 numpy reference
     where it lies within 30 dB of its peak, with its peaks within one grid
     step of the sources; ESPRIT and root-MUSIC on a 21-element ULA within
     1e-3 rad of the truth; co-array MUSIC resolving five sources on four
     sensors (tests/test_models.py:121) and the co-array lag averages twice
     bit-equal; ``nearfield_music`` and ``ml_localize`` finding an emitter's
     point of a 32^3 grid; each function timed on the card and at
     device="cpu"; (b) the fused server at scan depth 32 on phase 16's
     capture publishing through pyzmq on a free loopback port, and ``python3
     -m coherent_rtlsdr_tpu_torch.apps.music_client --follow`` on the card as
     a child process once the server is 21 / 21 synced: one launch of each
     fused kernel a block and no plain run, at least four heatmaps, the last
     peaking at broadside (the channels carry the reference noise in phase)
     within one grid step, its saved spectrum within 0.1 dB of the same
     spectrum recomputed at device="cpu" on the saved snapshots, and the
     client's spectrum ms an iteration beside the server's frame rate.

The fused main path at L = 32768 (m = 256, W = 65536), where each window
runs on a cluster of four CTAs (``csrc/fused_cluster.cuh``):

 19. (a) ``fused_measure_ref``, ``fused_measure_i8_spec``,
     ``fused_measure_i8`` and ``fused_apply_spec_i8`` against their plain
     versions at N = 21, T = 5, on random and correlated bytes (phase 2's
     bars), and on the same bytes the entries of kernel table rows 4-7
     (``fused_apply_i8``, the four-step, the float pair) against theirs
     (phase 20 (a)'s bars); (b) ``align_offline`` at T = 64 (1,323 windows, the sample count
     of phase 3): 1 + 1 + 1 launches a call, no plain run, samples/s over 7
     runs against 43.0e6, and the recompute measure on the same bytes, its
     scalars equal to the handoff's; (c) quality against synthetic truth
     by phase 4's bars; (d) each kernel against its plain version at (b)'s
     shapes, timed in turns and twice in one torch.profiler run; (e) a capture
     rendered on the card (762 blocks) served by ``FileSource`` to the
     fused server at scan depth 1 and 32, by phase 16's checks: samples/s
     (median of 3 windows; depth 32 must keep real time), the host parts,
     21 / 21, the frame bars, bit-equal to the packed runner, one launch of
     each kernel a block.

The generic path, ``FusedSpectral`` and the recompute pair at L = 32768
(m = 256), on the cluster kernels of kernel table rows 4-7:

 20. (a) ``fused_apply_i8``, the four-step forward and inverse and the
     float pair against their plain versions at N = 21, T = 5, on random
     and correlated bytes (phases 8 and 14's bars; the four-step also
     against torch.fft); (b) ``align_offline`` with ``fft_impl="pallas"``
     and ``phase_slope`` at T = 64 (1,323 windows): 2 + 2 four-step
     launches a call, no plain run, samples/s over 7 runs against 43.0e6,
     ``xla`` (cuFFT) beside it, peak memory, one call under
     torch.profiler, and generic quality at T = 16 by phase 10's bars;
     (c) ``FusedSpectral`` prepare -> measure -> correct at T = 64, by its
     launch counts, the float kernels against
     their plain versions at those shapes, timed over 3 calls; (d) the
     recompute pair on (b)'s bytes, held to the handoff pair by phase 14's
     contract; (e) each of the four kernels timed against its plain
     version in turns (the four-step at B = 1,323, forward and inverse,
     beside torch.fft) and two calls of each under torch.profiler; (f) the
     generic server (``pallas``) on phase 19's capture, 64 blocks at scan
     depth 8: 21 / 21, phase 16's frame bars on the last 16 frames, 2 + 2
     four-step launches a block.

The offline half of ``parallel/`` (one process a device, ranks of a
``torch.distributed`` group):

 21. (a) a one-rank NCCL group in this process at N = 21, L = 8192,
     T = 256: ``make_channel_sharded_align`` and
     ``make_fused_time_sharded_align`` (fused), ``make_sharded_align``
     (``torch.fft``) and ``make_auto_sharded_align`` (``pallas``, global
     and ema), each held to the unsharded engine on the same bytes by
     tests/test_parallel.py's bars (delay 1e-4 / 1e-3, mag 1e-5, aligned
     1e-3, wire 1 LSB) with its launch counts (1 + 1 + 1 fused kernels,
     2 + 2 four-step, no plain run), its ms over 7 runs in turns with
     the unsharded call's and the host time of a call of each, and one
     profiled call of the fused time-sharded runner and of the unsharded
     engine; (b) ranks that share the card over gloo, as
     child processes: ``align_offline --mesh 3 --fft-impl fused`` on a
     21-channel capture npz (T = 64) against the unsharded app's npz, and
     the fused time-sharded runner on a (2, 1) mesh (``chip_smoke.py
     --parallel-rank``) against the unsharded engine, each rank's launch
     counts 1 + 1 + 1; (b) prints the card's compute mode and does not run
     in an exclusive one.

The streaming server on a channel mesh (the serving half of ``parallel/``:
rank 0 runs ``CoherentServer(mesh=...)``, the other ranks
``serve_follower``):

 22. (a) a one-rank NCCL group in this process: the fused server on
     ``make_mesh(1, 1)`` and the unsharded server on phase 16's capture at
     scan depth 1 and 32, in turns: every frame byte-equal to the
     unsharded server's (the first 64 to the packed runner's), 21 / 21,
     phase 16's frame bars, one launch of each fused kernel a block and no
     plain run; samples/s (median of 3 windows each, depth 32 against
     43.0e6), the host ms a block by part, the mesh's header, scatter and
     gather among them, and at depth 1 the host operators under
     torch.profiler and the host ms of a runner call alone; then the ``pallas`` server on the mesh, 64
     blocks at depth 8, byte-equal to the unsharded one, 2 + 2 four-step
     launches a block; (b) ``coherent_server --mesh 3`` (three gloo ranks
     sharing the card, started by the app) on phase 21 (b)'s capture at
     depth 32, publishing through pyzmq to a SUB socket here: the last 16
     frames by phase 16's bars, its checkpoint 21 / 21 synced with delays
     within 1e-3 of the unsharded server's; (b) prints the compute mode
     and does not run in an exclusive one.

Every phase prints one JSON line (phases 19-22 one a part); a failed
check raises, so the exit code is not 0. Before the last line it prints the
ptxas report of every kernel (registers, stack, spills; the twenty-seven
tensor-core instantiations, twelve measure, nine apply and six four-step
ones, must use no stack and spill nothing), the card's name and power
limit and a JSON summary of seventeen kernel entries, the nine kernels
and the eight m = 256 ones (times, launches, errors, and the
bound from ``tools/cost_model.py``: the larger of bytes over 3.35 TB/s and
bf16 operations over 989 TFLOP/s); the last line is ``{"ok": true,
"device": {...}}``. Needs a CUDA device and the repository's package next
to this file.

``python3 chip_smoke.py --phase 22`` builds the kernels and runs phase 22
alone on phase 16's capture (its JSON lines only, no summary and no last
line): the quick way to time the mesh server against the unsharded one.
"""

import json
import os
import statistics
import sys
import time

import torch

# Bars (phase 2 and 6): kernel against plain version on the same inputs.
LAG_ATOL = 1e-3          # samples
SCALAR_RTOL = 1e-3       # |z|, mag, papr
D_ULP_SHARE = 1e-3       # share of D elements more than 1 bf16 ulp apart
WIRE_MAX_LSB = 2         # apply: max |diff| of the int8 wire bytes
WIRE_GT1_SHARE = 1e-3    # apply: share of wire bytes more than 1 LSB apart
MIN_CORR_MAG = 0.1       # PipelineConfig.min_corr_mag: measurements used at or above
# Quality bars (phase 4) on the port's own synthetic truth.
PHASE_ERR_DEG = 0.1
LAG_ERR_SAMPLES = 5e-3

# Generic path (phases 8-13): the four-step FFT against torch.fft
# (tests/test_kernels.py:81), kernel against plain version, and the float
# apply's output by the wire bars in float units.
FFT_PLAIN_REL = 1e-3     # max |kernel - plain| / max |plain|
FFT_LIB_REL = 3e-2       # max |kernel - torch.fft| / max |torch.fft| (bf16 products)
Y_MAX = 2.0 / 127.0      # float apply: max |diff|
Y_GT1_SHARE = 1e-3       # float apply: share of samples more than 1/127 apart
# Generic quality bars: the JAX package's own bf16 tests
# (tests/test_kernels.py:177-188).
GEN_LAG_MAX = 0.1        # max |delay - truth|, samples
GEN_PHASE_MAX_DEG = 3.0  # max |residual phase|, degrees

# Calls a timed run of the four-step kernel (phase 13) and of the copy
# (phase 15): back to back, so the host's launch time drops out.
FFT_REPS, COPY_REPS = 5, 20

N_CH, L = 21, 8192
T_OFFLINE, K_STREAM, CALLS_STREAM = 256, 32, 4
GENERIC = dict(fft_impl="pallas", lag_method="phase_slope")
# The recompute pair against the handoff pair (tests/test_kernels.py:433-450).
HANDOFF_SCALAR_TOL = 1e-6   # rtol and atol of the five scalars
HANDOFF_WIRE_NZ_SHARE = 0.35   # share of wire bytes that differ at all
RECOMPUTE_PHASE_MAX_DEG = 5.0   # wire block against the reference, per window


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=1):
    """Device time of one run of ``fn``, between two CUDA events around
    ``reps`` runs, over reps (ms). With reps > 1 the host enqueues ahead of
    the card, so the wrapper's host time drops out of a short kernel's."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_profile(fn):
    """Wall time (ms) of ``fn()`` to a synchronize, and the device time of
    the kernels it ran (from torch.profiler): total, idle share of the wall
    time, the five largest by name, and each of the port's kernels
    (``fused::name<m, ...>``, ``fourstep::name<...>``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    fused = {name.split("(")[0].removeprefix("void "): ms for name, ms in by_name.items()
             if "fused::" in name or "fourstep::" in name}
    return dict(wall_ms=wall, device_busy_ms=busy, idle_share=1.0 - busy / wall,
                kernel_names=len(by_name), top_ms=dict(top), fused_kernel_ms=fused)


def ulp_apart(a, b):
    """bf16 ulps between two bf16 tensors of the same sign pattern."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def compare_measure(got, want, where):
    """Hold the kernel's measure outputs (five scalars, then the stored
    spectra where the kernel stores them) to the plain version's.

    The scalars are held where the pipeline uses the measurement (mag >=
    MIN_CORR_MAG). On uncorrelated bytes the phase-zoom sums nearly cancel
    and float32 summation order alone moves the lag by up to ~0.3 samples
    (measured on the H100), so there only the accept/reject decision, the
    stored spectra and finiteness are held, and the spread is reported."""
    names = ("lag", "z_re", "z_im", "mag", "papr")
    for name, x in zip(names, got):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{where}: non-finite {name}")
    used = want[3] >= MIN_CORR_MAG
    if not torch.equal(got[3] >= MIN_CORR_MAG, used):
        raise AssertionError(f"{where}: kernel and plain version gate windows differently")
    rel = {"windows_used": int(used.sum().item()), "windows": used.numel(),
           "lag_max_abs_err_unused": (got[0] - want[0])[~used].abs().max().item()
           if (~used).any() else 0.0}
    lag_err = (got[0] - want[0])[used].abs().max().item() if used.any() else 0.0
    if not lag_err <= LAG_ATOL:
        raise AssertionError(f"{where}: lag off by {lag_err} > {LAG_ATOL}")
    zabs_g = torch.sqrt(got[1] ** 2 + got[2] ** 2)
    zabs_w = torch.sqrt(want[1] ** 2 + want[2] ** 2)
    for name, g, w in (("|z|", zabs_g, zabs_w), ("mag", got[3], want[3]),
                       ("papr", got[4], want[4])):
        rel[name] = ((g - w).abs() / w.abs().clamp(min=1e-30))[used].max().item() \
            if used.any() else 0.0
        if not rel[name] <= SCALAR_RTOL:
            raise AssertionError(f"{where}: {name} rel err {rel[name]} > {SCALAR_RTOL}")
    for name, g, w in zip(("dre", "dim"), got[5:], want[5:]):
        share = (ulp_apart(g, w) > 1).float().mean().item()
        rel[f"{name}_share_gt1ulp"] = share
        if not share < D_ULP_SHARE:
            raise AssertionError(f"{where}: {name} share > 1 ulp {share} >= {D_ULP_SHARE}")
    return lag_err, rel


def compare_ref(got, want, where):
    """Hold the reference kernel's (R, eref) to the plain version's: R, the
    same transform as D kept in float32, by the D bar after rounding both to
    bf16; eref to SCALAR_RTOL."""
    (r_got, e_got), (r_want, e_want) = got, want
    if not (torch.isfinite(r_got).all() and torch.isfinite(e_got).all()):
        raise AssertionError(f"{where}: non-finite reference spectrum")
    share = (ulp_apart(r_got.to(torch.bfloat16), r_want.to(torch.bfloat16)) > 1) \
        .float().mean().item()
    e_rel = ((e_got - e_want).abs() / e_want.clamp(min=1e-30)).max().item()
    if not (share < D_ULP_SHARE and e_rel <= SCALAR_RTOL):
        raise AssertionError(f"{where}: R share > 1 ulp {share}, eref rel err {e_rel}")
    return dict(R_max_abs_err=(r_got - r_want).abs().max().item(),
                R_max_abs=r_want.abs().max().item(), R_share_gt1ulp=share, eref_rel_err=e_rel)


def hold_measure(k, raw, ref_raw, where):
    """Both measure kernels against their plain versions on the same bytes.
    measure_spec gets the reference kernel's R on both sides, so each kernel
    is held alone. Returns (errors, plain measure_spec outputs)."""
    r_got = k.measure_ref(ref_raw)
    r_want = k.measure_ref_plain(ref_raw)
    got = k.measure_spec(raw, *r_got)
    want = k.measure_spec_plain(raw, *r_got)
    torch.cuda.synchronize()
    errs = compare_ref(r_got, r_want, where)
    errs["lag_max_abs_err"], errs["rel_err"] = compare_measure(got, want, where)
    errs["mag_min"] = want[3].min().item()
    return errs, want


def compare_wire(got, want, where):
    d = (got.int() - want.int()).abs()
    mx, share = d.max().item(), (d > 1).float().mean().item()
    if not (mx <= WIRE_MAX_LSB and share < WIRE_GT1_SHARE):
        raise AssertionError(f"{where}: wire max {mx} LSB, share > 1 LSB {share}")
    return mx, share


def hold_apply(k, args, where):
    """The apply kernel against its plain version on the same arguments."""
    mx, share = compare_wire(k.apply_spec_i8(*args), k.apply_spec_i8_plain(*args), where)
    return dict(wire_max_lsb=mx, wire_share_gt1=share)


WRAPPERS = ("measure_ref", "measure_spec", "apply_spec_i8")


def kernel_inputs(k, fn):
    """Run ``fn()`` with each kernel wrapper of ``k`` recording its
    arguments; returns ``{wrapper: arguments of its last call}``."""
    seen = {}

    def recorder(name, wrapped):
        def record(*args):
            seen[name] = args
            return wrapped(*args)
        return record

    for name in WRAPPERS:
        setattr(k, name, recorder(name, getattr(k, name)))
    try:
        fn()
    finally:
        for name in WRAPPERS:
            delattr(k, name)
    return seen


def launched_only(counts, want, where):
    """The counts are ``want`` (launches) and zero everywhere else: no plain
    version ran."""
    full = dict.fromkeys(counts, 0) | want
    if counts != full:
        raise AssertionError(f"{where} did not run through the kernels: {counts}, want {full}")


def graph_counts(srv, served, depth, where):
    """A fused server on the card replays its depth-1 step as one CUDA graph
    (``pipeline/graphed.py``): at depth 1, one capture and a replay a block
    served; a deeper server's scan runs eagerly. Returns the two counters."""
    got = dict(graph_captures=srv.graph_captures, graph_replays=srv.graph_replays)
    if depth == 1 and got != dict(graph_captures=1, graph_replays=served):
        raise AssertionError(f"{where}: {got} with {served} blocks served")
    return got


def launched_only_kernels(counts, n, where):
    """Every i8 kernel launched n times, nothing else run."""
    launched_only(counts, dict(measure_ref_launches=n, measure_spec_launches=n,
                               apply_spec_i8_launches=n), where)


def timed_interleaved(fns, bases, variants, reps=1):
    """Median ms of each ``fns[base + variant]`` over four runs in turns
    (first, second, second, first variant), after a warm-up of each; each
    run times ``reps`` calls (see cuda_ms)."""
    times = {name: [] for name in fns}
    for name in fns:
        cuda_ms(fns[name])
    for order in (variants, variants[::-1], variants[::-1], variants):
        for base in bases:
            for v in order:
                times[base + v].append(cuda_ms(fns[base + v], reps))
    return {name: statistics.median(v) for name, v in times.items()}, times


def synth_raw(n_blocks, block_len, n_ch, seed, dev):
    """Correlated signed blocks from the port's synthesizer: (raw [T, N,
    m/2, 2m], ref_raw [T, m/2, 2m], capture)."""
    from coherent_rtlsdr_tpu_torch.ops.convert import u8_to_i8
    from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture

    m = int(round((2 * block_len) ** 0.5))
    truth = make_truth(n_ch, seed=seed, max_delay=40.0, snr_db=30.0)
    cap = synth_capture(torch.Generator(device=dev).manual_seed(seed), truth,
                        n_blocks=n_blocks, block_len=block_len)
    raw = u8_to_i8(cap.sig_u8.reshape(n_blocks, n_ch, m // 2, 2 * m))
    ref_raw = u8_to_i8(cap.ref_u8.reshape(n_blocks, m // 2, 2 * m))
    return raw, ref_raw, cap


def small_blocks(m, g, dev, seed=None):
    """The kernel-vs-plain inputs at m (N = 21, T = 5): random bytes drawn
    from ``g``, and the synthesizer's correlated bytes (``seed``, by
    default m)."""
    return {
        "random": (
            torch.randint(-128, 128, (5, N_CH, m // 2, 2 * m), generator=g, device=dev,
                          dtype=torch.int8),
            torch.randint(-128, 128, (5, m // 2, 2 * m), generator=g, device=dev,
                          dtype=torch.int8)),
        "correlated": synth_raw(5, m * m // 2, N_CH, seed=m if seed is None else seed,
                                dev=dev)[:2],
    }


def phase_kernels(dev):
    """Phase 2: kernel against plain version at m = 128 and m = 64."""
    from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels

    out = []
    for m, n_ch in ((128, N_CH), (64, N_CH)):
        k = FusedPipelineKernels(m * m, dev)
        g = torch.Generator(device=dev).manual_seed(m)
        for kind, (raw, ref_raw) in small_blocks(m, g, dev).items():
            where = f"m={m} {kind}"
            errs, want = hold_measure(k, raw, ref_raw, where)
            adv = (torch.rand((4, n_ch), generator=g, device=dev) - 0.5) * 80.0
            ph = torch.rand((4, n_ch), generator=g, device=dev) * 6.283185307179586
            errs.update(hold_apply(k, (want[5], want[6], adv, torch.cos(ph), torch.sin(ph)),
                                   where))
            out.append(dict(m=m, N=n_ch, T=5, inputs=kind, **errs))
    return out


def offline_run(cfg, sig_u8, ref_u8):
    from coherent_rtlsdr_tpu_torch.pipeline import align_offline

    return align_offline(cfg, sig_u8, ref_u8, smoothing="global")


def planes_from_i8(raw, ref_raw, fft):
    """Float-path inputs from signed blocks: bf16 block planes pre/pim
    ``[T, N, m/2, m]`` and the reference window spectra rre/rim ``[T-1, m,
    m]`` (through ``fft``, an FFT4StepKernel)."""
    from coherent_rtlsdr_tpu_torch.ops.convert import i8_iq_to_c64

    T, N, m2, m = raw.shape[0], raw.shape[1], raw.shape[2], raw.shape[3] // 2
    sig = i8_iq_to_c64(raw.reshape(T, N, m2 * m, 2)).reshape(T, N, m2, m)
    ref = i8_iq_to_c64(ref_raw.reshape(T, m2 * m, 2))
    R = fft.fft(torch.cat([ref[:-1], ref[1:]], dim=-1))
    bf = lambda x: x.to(torch.bfloat16)
    return bf(sig.real), bf(sig.imag), bf(R.real), bf(R.imag)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def hold_fourstep(k, x, where):
    """The four-step kernel forward and inverse against its plain version
    and torch.fft on ``x [B, W]`` complex64."""
    m = k.m
    X = torch.fft.fft(x).reshape(-1, m, m).transpose(-1, -2)   # natural -> (k2, k1)
    fwd, fwd_plain = k.fft(x), k.fft_plain(x)
    inv, inv_plain = k.ifft(X), k.ifft_plain(X)
    torch.cuda.synchronize()
    errs = dict(fwd_rel_plain=rel_err(fwd, fwd_plain), fwd_rel_torch_fft=rel_err(fwd, X),
                inv_rel_plain=rel_err(inv, inv_plain), inv_rel_torch_fft=rel_err(inv, x),
                fwd_max_abs_err=(fwd - fwd_plain).abs().max().item(),
                inv_max_abs_err=(inv - inv_plain).abs().max().item())
    if not (errs["fwd_rel_plain"] <= FFT_PLAIN_REL and errs["inv_rel_plain"] <= FFT_PLAIN_REL
            and errs["fwd_rel_torch_fft"] < FFT_LIB_REL
            and errs["inv_rel_torch_fft"] < FFT_LIB_REL):
        raise AssertionError(f"{where}: four-step kernel off: {errs}")
    return errs


def hold_float_measure(k, planes, where):
    """The float measure kernel against its plain version: lag, |z|, sum
    |D|^2 and sum |G|^2 by the i8 measure bars where the window is used."""
    got = k.measure(*planes)
    want = k.measure_plain(*planes)
    torch.cuda.synchronize()
    for x in got:
        if not torch.isfinite(x).all():
            raise AssertionError(f"{where}: non-finite float measure output")
    rre, rim = planes[2].float(), planes[3].float()
    eref = (rre * rre + rim * rim).sum((-2, -1))[:, None]
    mag = lambda out: out[1] / torch.sqrt(out[2] * eref).clamp(min=1e-30)
    used = mag(want) >= MIN_CORR_MAG
    if not torch.equal(mag(got) >= MIN_CORR_MAG, used):
        raise AssertionError(f"{where}: float measure gates windows differently")
    errs = dict(windows_used=int(used.sum().item()), windows=used.numel())
    errs["lag_max_abs_err"] = (got[0] - want[0])[used].abs().max().item() if used.any() else 0.0
    if not errs["lag_max_abs_err"] <= LAG_ATOL:
        raise AssertionError(f"{where}: float lag off by {errs['lag_max_abs_err']}")
    for name, g, w in zip(("|z|", "sum|D|^2", "sum|G|^2"), got[1:], want[1:]):
        errs[name] = ((g - w).abs() / w.abs().clamp(min=1e-30))[used].max().item() \
            if used.any() else 0.0
        if not errs[name] <= SCALAR_RTOL:
            raise AssertionError(f"{where}: float {name} rel err {errs[name]}")
    return errs


def hold_float_apply(k, planes, adv, where):
    """The float apply kernel against its plain version by the float wire
    bars."""
    got = k.apply(planes[0], planes[1], adv)
    want = k.apply_plain(planes[0], planes[1], adv)
    torch.cuda.synchronize()
    d = torch.stack([(got[0] - want[0]).abs(), (got[1] - want[1]).abs()])
    mx, share = d.max().item(), (d > 1.0 / 127.0).float().mean().item()
    if not (mx <= Y_MAX and share < Y_GT1_SHARE):
        raise AssertionError(f"{where}: float apply max {mx}, share > 1/127 {share}")
    return dict(y_max_abs_err=mx, y_share_gt_1_127=share)


def phase_generic_kernels(dev):
    """Phase 8: the generic kernels against their plain versions."""
    from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel
    from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels

    out = []
    # The four-step kernel's persistent grid is one CTA an SM.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in (128, 64):
        fk = FFT4StepKernel(m * m, dev)
        k = FusedPipelineKernels(m * m, dev)
        g = torch.Generator(device=dev).manual_seed(m + 1)
        x = torch.complex(torch.randn((2 * N_CH, m * m), generator=g, device=dev),
                          torch.randn((2 * N_CH, m * m), generator=g, device=dev))
        out.append(dict(kernel="fourstep", m=m, B=2 * N_CH, **hold_fourstep(fk, x, f"m={m}")))
        # The persistent grid: one round short, one transform over, and
        # several rounds with a ragged last one.
        for B in (1, sms - 1, sms + 1, 3 * sms + 5):
            xb = torch.complex(torch.randn((B, m * m), generator=g, device=dev),
                               torch.randn((B, m * m), generator=g, device=dev))
            out.append(dict(kernel="fourstep", m=m, B=B, sms=sms,
                            **hold_fourstep(fk, xb, f"m={m} B={B}")))
        for kind, (raw, ref_raw) in small_blocks(m, g, dev).items():
            where = f"float m={m} {kind}"
            planes = planes_from_i8(raw, ref_raw, fk)
            errs = hold_float_measure(k, planes, where)
            adv = (torch.rand((4, N_CH), generator=g, device=dev) - 0.5) * 80.0
            adv[0, 0], adv[0, 1] = -1500.25, 1023.5
            errs.update(hold_float_apply(k, planes, adv, where))
            out.append(dict(kernel="measure/apply", m=m, N=N_CH, T=5, inputs=kind, **errs))
    return out


def hold_recompute(k, raw, ref_raw, args, where):
    """The recompute kernels against their plain versions: fused_measure_i8
    on the reference kernel's spectra on both sides (so it is held alone,
    as in hold_measure), fused_apply_i8 on the same bytes and arguments."""
    got = k.measure_i8(raw, ref_raw)
    want = k.measure_i8_plain(raw, *k.measure_ref(ref_raw))
    torch.cuda.synchronize()
    errs = {}
    errs["lag_max_abs_err"], errs["rel_err"] = compare_measure(got, want, where)
    errs["mag_min"] = want[3].min().item()
    mx, share = compare_wire(k.apply_i8(raw, *args), k.apply_i8_plain(raw, *args), where)
    errs.update(wire_max_lsb=mx, wire_share_gt1=share)
    return errs


def phase_recompute_kernels(dev):
    """Phase 14, first part: the recompute kernels against their plain
    versions at m = 128 and m = 64, with advances of large integer part."""
    from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels

    out = []
    for m in (128, 64):
        k = FusedPipelineKernels(m * m, dev)
        g = torch.Generator(device=dev).manual_seed(m + 2)
        for kind, (raw, ref_raw) in small_blocks(m, g, dev).items():
            adv = (torch.rand((4, N_CH), generator=g, device=dev) - 0.5) * 80.0
            adv[0, 0], adv[0, 1] = -1500.25, 1023.5
            ph = torch.rand((4, N_CH), generator=g, device=dev) * 6.283185307179586
            errs = hold_recompute(k, raw, ref_raw, (adv, torch.cos(ph), torch.sin(ph)),
                                  f"recompute m={m} {kind}")
            out.append(dict(m=m, N=N_CH, T=5, inputs=kind, **errs))
    return out


def hold_handoff_contract(rec, wire_r, spec, wire_h):
    """The recompute pair against the handoff pair on the same bytes: the
    five scalars equal within HANDOFF_SCALAR_TOL, the wire bytes within the
    wire bars and under HANDOFF_WIRE_NZ_SHARE of them different at all
    (the bf16 rounding of the stored D)."""
    out = {}
    for name, a, b in zip(("lag", "z_re", "z_im", "mag", "papr"), rec, spec):
        err = (a - b).abs()
        out[f"{name}_max_abs_diff"] = err.max().item()
        if not (err <= HANDOFF_SCALAR_TOL * (1 + b.abs())).all():
            raise AssertionError(f"handoff contract: {name} differs by {err.max().item()}")
    mx, share = compare_wire(wire_r, wire_h, "handoff contract")
    nz = (wire_r != wire_h).float().mean().item()
    if not nz < HANDOFF_WIRE_NZ_SHARE:
        raise AssertionError(f"handoff contract: {nz} of the wire bytes differ")
    out.update(wire_max_lsb=mx, wire_share_gt1=share, wire_share_nonzero=nz)
    return out


def wire_phase_deg(wire, ref_raw):
    """Per (window, channel): the phase (degrees) of the wire block's
    correlation with the reference's overlap-save centre half."""
    T1, N = wire.shape[:2]
    y = wire.reshape(T1, N, -1, 2).float()
    r = ref_raw.reshape(T1 + 1, -1, 2).float()
    half = r.shape[1] // 2
    rc = torch.cat([r[:-1, half:], r[1:, :half]], dim=1)
    z = (torch.complex(y[..., 0], y[..., 1])
         * torch.complex(rc[..., 0], -rc[..., 1])[:, None]).sum(-1)
    return torch.rad2deg(torch.angle(z))


# Phase 16: the streaming server (io/server.py) at N = 21, L = 8192.
SERVER_WARM = 64              # blocks before the timed windows
SERVER_WINDOW = {1: 128, 32: 256}   # blocks a timed window, by scan depth
SERVER_WINDOWS = 3
SERVER_SLAB = 254             # blocks a rendered slab (a 256-block window)
REALTIME_SAMPLES_S = N_CH * 2.048e6   # the reference's operating point, 43.0e6
FRAME_CORR_MIN = 0.99         # each channel against channel 0 (the verify criteria)
FRAME_PHASE_MAX_DEG = 1.0
FARROW_ATOL = 1e-5            # Farrow on the card against the CPU


class RecordingPublisher:
    """The server's publisher in this script (the card's machine has no
    pyzmq): it serializes every frame and its phases in the wire format,
    as the ZMQ publisher does before its send, and keeps the first
    ``keep_first`` frames, the last 16 and every ref seqnum."""

    def __init__(self, keep_first=0):
        import collections

        self.keep_first = keep_first
        self.first, self.last = [], collections.deque(maxlen=16)
        self.ref_seqs, self.seqnums = [], []

    def publish(self, iq_i8, seqnums, phases=None):
        from coherent_rtlsdr_tpu_torch.io.wire import pack_debug, pack_frame

        buf = pack_frame(len(self.ref_seqs), seqnums, iq_i8)
        if phases is not None:
            pack_debug(phases)
        self.ref_seqs.append(int(seqnums[0]))
        self.seqnums.append(seqnums)
        if len(self.first) < self.keep_first:
            self.first.append(buf)
        self.last.append(buf)
        return len(buf)


class QueueControl:
    """A scripted control socket: queued commands are handled at the loop's
    next poll (once a batch), and their replies kept."""

    def __init__(self):
        self.queue, self.replies = [], {}

    def poll(self, handler, timeout_ms=0):
        n = 0
        while self.queue:
            cmd = self.queue.pop(0)
            self.replies[cmd] = handler(cmd)
            n += 1
        return n


def render_capture(n_blocks, dev, seed=11, block_len=L):
    """A continuous synthetic capture of ``block_len`` samples a block,
    rendered on the card slab by slab (``synth_stream_slab``: max delay 40,
    SNR 30 dB, ppm 0) and kept in host memory, its seqnums counting from 1:
    (Capture, truth)."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.io.streamio import Capture
    from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_stream_slab

    truth = make_truth(N_CH, seed=seed, max_delay=40.0, snr_db=30.0)
    n_slabs = -(-n_blocks // SERVER_SLAB)
    T = n_slabs * SERVER_SLAB
    sig = np.empty((T, N_CH, block_len, 2), np.uint8)
    ref = np.empty((T, block_len, 2), np.uint8)
    for i in range(n_slabs):
        s, r = synth_stream_slab(seed, truth, i, SERVER_SLAB, block_len, device=dev)
        sig[i * SERVER_SLAB:(i + 1) * SERVER_SLAB] = s.cpu().numpy()
        ref[i * SERVER_SLAB:(i + 1) * SERVER_SLAB] = r.cpu().numpy()
    seqnums = np.tile(np.arange(1, T + 1, dtype=np.uint32)[:, None], (1, N_CH))
    return Capture(sig_u8=sig, ref_u8=ref, seqnums=seqnums, fs=2.048e6, fcenter=1024e6), truth


def sub_capture(cap, start, stop, restart_seqnums=False):
    """Blocks [start, stop) of a capture (a restarted capture counts its
    seqnums from 1 again)."""
    from coherent_rtlsdr_tpu_torch.io.streamio import Capture

    seq = cap.seqnums[: stop - start] if restart_seqnums else cap.seqnums[start:stop]
    return Capture(sig_u8=cap.sig_u8[start:stop], ref_u8=cap.ref_u8[start:stop], seqnums=seq,
                   fs=cap.fs, fcenter=cap.fcenter)


def check_frames(bufs, n, where, block_len=L):
    """Every frame is (n + 1) x block_len int8 IQ, and each channel against
    channel 0 peaks at lag 0 with corr >= FRAME_CORR_MIN and |phase| <
    FRAME_PHASE_MAX_DEG. Returns the worst corr and phase."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.io.wire import unpack_frame

    corr_min, phase_max = 1.0, 0.0
    for buf in bufs:
        f = unpack_frame(buf)
        if not (f.iq.shape == (n + 1, block_len, 2) and f.iq.dtype == np.int8):
            raise AssertionError(f"{where}: frame of shape {f.iq.shape}, {f.iq.dtype}")
        x = f.iq[..., 0].astype(np.float64) + 1j * f.iq[..., 1]
        X = np.fft.fft(x, axis=-1)
        lag = np.abs(np.fft.ifft(X[1:] * X[0].conj(), axis=-1)).argmax(-1)
        z = (x[1:] * x[0].conj()).sum(-1)
        corr = np.abs(z) / (np.linalg.norm(x[1:], axis=-1) * np.linalg.norm(x[0]))
        phase = np.abs(np.degrees(np.angle(z)))
        if not ((lag == 0).all() and (corr >= FRAME_CORR_MIN).all()
                and (phase < FRAME_PHASE_MAX_DEG).all()):
            raise AssertionError(f"{where}: lags {lag}, corr min {corr.min()}, "
                                 f"|phase| max {phase.max()} deg")
        corr_min, phase_max = min(corr_min, corr.min()), max(phase_max, phase.max())
    return dict(frames_checked=len(bufs), corr_min=float(corr_min),
                phase_max_deg=float(phase_max))


def synced_line(srv, n, where):
    line = srv.status().splitlines()[0]
    if line != f"{n} / {n} synchronized":
        raise AssertionError(f"{where}: status says '{line}'")
    return line


def contiguous(seqs, first, where):
    if seqs != list(range(first, first + len(seqs))):
        raise AssertionError(f"{where}: ref seqnums not contiguous from {first}: "
                             f"{seqs[:4]} ... {seqs[-4:]}")


def runner_frames(cfg, cap, n_blocks, dev):
    """The packed scan runner on the capture's first blocks from the initial
    state, K = 32 a call: the frames as [T, N + 1, L, 2] int8 (ref first),
    L = cfg.block_len."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.pipeline import init_state, make_packed_scan_runner
    from coherent_rtlsdr_tpu_torch.pipeline.state import pack_state

    run = make_packed_scan_runner(cfg)
    pstate = pack_state(init_state(cfg, dev))
    gate = torch.tensor(True, device=dev)
    n, bl = cfg.n_channels, cfg.block_len
    out = []
    for c in range(0, n_blocks, K_STREAM):
        blk = slice(c, c + K_STREAM)
        sigs = torch.from_numpy(cap.sig_u8[blk]).to(dev).reshape(-1, n, 2 * bl)
        refs = torch.from_numpy(cap.ref_u8[blk]).to(dev).reshape(-1, 2 * bl)
        seqs = torch.from_numpy(cap.seqnums[blk].astype(np.int64)).to(dev)
        pstate, (wire, wire_ref), _ = run(pstate, sigs, refs, gate, seqs)
        out.append(torch.cat([wire_ref.reshape(-1, 1, bl, 2), wire.reshape(-1, n, bl, 2)],
                             dim=1).cpu().numpy())
    return np.concatenate(out)


def bit_equal(bufs, want, where):
    from coherent_rtlsdr_tpu_torch.io.wire import unpack_frame

    for t, buf in enumerate(bufs):
        if not (unpack_frame(buf).iq == want[t]).all():
            raise AssertionError(f"{where}: frame {t} differs from the packed runner's")
    return len(bufs)


def timed_server(cfg, cap, scan_depth, k, dev, window=SERVER_WINDOW):
    """A server at ``scan_depth`` on the capture from its start: a warm-up
    run, then SERVER_WINDOWS timed runs of ``window[scan_depth]`` blocks.
    Returns (server, publisher, wall seconds and frames of each window)."""
    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

    pub = RecordingPublisher(keep_first=SERVER_WARM)
    srv = CoherentServer(cfg, FileSource(cap), publisher=pub, control=QueueControl(),
                         scan_depth=scan_depth, device=dev)
    k.reset_counts()
    if srv.run(max_blocks=SERVER_WARM) != SERVER_WARM:
        raise AssertionError(f"server K={scan_depth}: warm-up published too few frames")
    windows = []
    for _ in range(SERVER_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = srv.run(max_blocks=window[scan_depth])
        windows.append((time.perf_counter() - t0, n))
    return srv, pub, windows


def host_breakdown(srv, n_blocks):
    """One more run of ``srv`` with the port's host spans recorded
    (``utils.SPANS``, enabled for the run), in ms a block:

      source          ``server.source`` (the source's ``next_block``)
      stage           ``server.stage`` (pad + pinned upload)
      dispatch        ``server.dispatch`` (the runner's launches)
      main_rest       the run's wall clock less the three above (queue
                      waits for the worker, control polls, the loop)
      worker_fetch    ``server.fetch`` (its wait for the device included)
      worker_publish  ``server.publish`` (frame assembly and publish)

    On a mesh server, three parts of dispatch besides:

      dispatch_mesh_header   ``mesh.header`` (the control header's gloo
                             broadcast, posted without a wait)
      dispatch_mesh_scatter  ``mesh.scatter`` (the blocks packed and
                             scattered)
      dispatch_mesh_gather   ``mesh.gather`` (the outputs packed and
                             gathered)

    ``longest_call_ms``: each part's longest single span, which tells a
    steady cost from a few stalls.
    """
    from coherent_rtlsdr_tpu_torch.utils import SPANS

    SPANS.clear()
    SPANS.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = srv.run(max_blocks=n_blocks)
        wall = time.perf_counter() - t0
    finally:
        SPANS.disable()
    summary = SPANS.summary(t0)
    if summary["dropped"]:
        raise AssertionError(f"host_breakdown: {summary['dropped']} spans dropped")
    parts = dict(source="server.source", stage="server.stage", dispatch="server.dispatch",
                 fetch="server.fetch", publish="server.publish")
    if srv.mesh is not None:
        parts.update(mesh_header="mesh.header", mesh_scatter="mesh.scatter",
                     mesh_gather="mesh.gather")
    spans = {part: summary["spans"].get(name, dict(total_ms=0.0, max_ms=0.0))
             for part, name in parts.items()}
    ms = lambda part: spans[part]["total_ms"] / n
    mesh = ({} if "mesh_header" not in spans else
            dict(dispatch_mesh_header=ms("mesh_header"),
                 dispatch_mesh_scatter=ms("mesh_scatter"),
                 dispatch_mesh_gather=ms("mesh_gather")))
    main = ms("source") + ms("stage") + ms("dispatch")
    return dict(blocks=n, wall_ms_per_block=wall * 1e3 / n, source=ms("source"),
                stage=ms("stage"), dispatch=ms("dispatch"), **mesh,
                main_rest=wall * 1e3 / n - main, worker_fetch=ms("fetch"),
                worker_publish=ms("publish"),
                longest_call_ms={part: d["max_ms"] for part, d in spans.items()})


def phase_server(dev, smi, k, fk):
    """Phase 16: the streaming server on the fused path, then its console,
    hot-plug and checkpoint, the generic path, and Farrow on the card.
    Returns (the phase's record, fused kernel launches, four-step
    launches)."""
    import os
    import tempfile

    import numpy as np

    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.ops.delay import farrow_fractional_delay
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
    from coherent_rtlsdr_tpu_torch.signal import make_truth
    from coherent_rtlsdr_tpu_torch.signal.sources import FileSource, SyntheticStreamSource

    cfg = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                         lag_method="phase_zoom")
    per_window = N_CH * L
    need = 2 * SERVER_WARM + (SERVER_WINDOWS + 1) * SERVER_WINDOW[32] + 8
    t0 = time.perf_counter()
    cap, truth = render_capture(need, dev)
    render_s = time.perf_counter() - t0
    want = runner_frames(cfg, cap, SERVER_WARM, dev)
    launches = dict.fromkeys(k.counts(), 0)
    out = dict(phase="server", card=smi, N=N_CH, L=L, fft_impl="fused",
               capture_blocks=cap.n_blocks, render_s=render_s)

    def add(counts):
        for name, v in counts.items():
            launches[name] += v

    # Scan depth 1 and 32: rates, sync, contiguous ref seqnums, frame
    # contents, launch counts, and the frames against the bare runner.
    for depth in (1, 32):
        where = f"server K={depth}"
        srv, pub, windows = timed_server(cfg, cap, depth, k, dev)
        rates = [n * per_window / s for s, n in windows]
        rec = dict(window_blocks=SERVER_WINDOW[depth], window_s=[s for s, _ in windows],
                   samples_per_s=rates, samples_per_s_median=statistics.median(rates),
                   realtime=statistics.median(rates) >= REALTIME_SAMPLES_S,
                   status=synced_line(srv, N_CH, where))
        rec["host_ms_per_block"] = host_breakdown(srv, SERVER_WINDOW[depth])
        served = SERVER_WARM + sum(n for _, n in windows) + SERVER_WINDOW[depth]
        if depth == 32:
            # One more run under the profiler: the loop's idle share.
            prof = device_profile(lambda: srv.run(max_blocks=SERVER_WARM))
            served += SERVER_WARM
            rec["profile"] = {key: prof[key] for key in
                              ("wall_ms", "device_busy_ms", "idle_share", "top_ms",
                               "fused_kernel_ms")}
            checkpoint_src = srv
        counts = k.counts()
        launched_only_kernels(counts, served, where)
        add(counts)
        contiguous(pub.ref_seqs, 1, where)
        rec.update(blocks_served=served, launches=counts,
                   **graph_counts(srv, served, depth, where),
                   frames=check_frames(pub.last, N_CH, where),
                   bit_equal_to_runner=bit_equal(pub.first, want, where))
        out[f"scan_depth_{depth}"] = rec

    # Console commands mid-run and padded hot-plug (max_channels = 24) on a
    # synthetic stream rendered on the card.
    ctl = QueueControl()
    pub = RecordingPublisher()
    src = SyntheticStreamSource(make_truth(N_CH, seed=12, max_delay=40.0, snr_db=30.0),
                                block_len=L, slab_blocks=62, seed=12, device=dev)
    srv = CoherentServer(cfg, src, publisher=pub, control=ctl, scan_depth=8,
                         max_channels=24, device=dev)
    k.reset_counts()

    def run_with(cmds, blocks):
        ctl.queue += cmds
        if srv.run(max_blocks=blocks) != blocks:
            raise AssertionError(f"console server: published too few frames after {cmds}")

    run_with([], SERVER_WARM)
    first = synced_line(srv, N_CH, "console warm-up")
    run_with(["status", "phase", "request rd"], 16)
    gate_off = srv.refnoise_enabled is False and not src.refnoise_enabled
    run_with(["request re", "fcenter 868000000"], 16)
    builds = srv.n_runner_builds
    run_with(["fs 1024000"], 8)
    fs_ok = (srv.cfg.fs == 1024000.0 and srv._resync_requested
             and srv.n_runner_builds == builds + 1)
    run_with([], 16)
    after_fs = synced_line(srv, N_CH, "after the fs change")
    builds = srv.n_runner_builds
    run_with(["add NEWCH"], 8)
    run_with([], 48)
    after_add = synced_line(srv, N_CH + 1, "after add")
    frames_add = check_frames([pub.last[-1]], N_CH + 1, "after add")
    run_with(["del SYN 1"], 8)
    run_with([], 16)
    after_del = synced_line(srv, N_CH, "after del")
    frames_del = check_frames([pub.last[-1]], N_CH, "after del")
    r = ctl.replies
    console_ok = (r["status"].startswith(first) and len(r["phase"].split("\t")) == N_CH
                  and r["request rd"] == "disable refnoise" and gate_off
                  and r["request re"] == "enable refnoise" and srv.refnoise_enabled
                  and r["fcenter 868000000"] == "fcenter set to 868000000"
                  and srv.fcenter == 868000000.0 and r["fs 1024000"] == "fs set to 1024000"
                  and fs_ok and r["add NEWCH"] == f"added 'NEWCH' as channel {N_CH + 1}"
                  and r["del SYN 1"] == "deleted 'SYN 1'"
                  and srv.n_runner_builds == builds and srv.n_active == N_CH)
    if not console_ok:
        raise AssertionError(f"console: replies {r}, fs_ok {fs_ok}, gate_off {gate_off}, "
                             f"runner builds {srv.n_runner_builds} (was {builds})")
    counts = k.counts()
    launched_only_kernels(counts, len(pub.ref_seqs), "console server")
    add(counts)
    contiguous(pub.ref_seqs, 1, "console server")
    out["console"] = dict(replies=r, blocks_served=len(pub.ref_seqs), launches=counts,
                          status=[first, after_fs, after_add, after_del],
                          frames_after_add=frames_add, frames_after_del=frames_del,
                          runner_builds=srv.n_runner_builds, max_channels=24)

    # Checkpoint: save the depth-32 server's calibration, restore it into a
    # new server on the next blocks of the capture (restarted: seqnums from
    # 1): synced from the start, no re-sync, ref seqnums continuing.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calibration.npz")
        checkpoint_src.save_state(path)
        saved = checkpoint_src.state
        pub = RecordingPublisher()
        start = 2 * SERVER_WARM + (SERVER_WINDOWS + 1) * SERVER_WINDOW[32]
        restored = CoherentServer(cfg, FileSource(sub_capture(cap, start, start + 8, True)),
                                  publisher=pub, control=QueueControl(), state_path=path,
                                  device=dev)
        st = restored.state
        k.reset_counts()
        restored_synced = bool(st.synced.all())
        n = restored.run(max_blocks=4)
        counts = k.counts()
    launched_only_kernels(counts, 4, "restored server")
    add(counts)
    delay_moved = float(np.abs(restored.state.delay - saved.delay).max())
    contiguous(pub.ref_seqs, int(saved.block_idx) + 1, "restored server")
    if not (restored_synced and n == 4 and np.array_equal(st.delay, saved.delay)
            and delay_moved < 0.05):
        raise AssertionError(f"checkpoint: synced {restored_synced}, published {n}, "
                             f"delay moved {delay_moved}")
    out["checkpoint"] = dict(restored_synced=restored_synced,
                             status=synced_line(restored, N_CH, "restored server"),
                             first_ref_seq=pub.ref_seqs[0], saved_block_idx=int(saved.block_idx),
                             max_abs_delay_moved=delay_moved,
                             # the first frame's window is half the zero history
                             frames=check_frames(list(pub.last)[1:], N_CH, "restored server"))

    # The generic path: fft_impl="pallas", 64 blocks at scan depth 8.
    gcfg = PipelineConfig(n_channels=N_CH, block_len=L, **GENERIC)
    pub = RecordingPublisher()
    gsrv = CoherentServer(gcfg, FileSource(sub_capture(cap, 0, 64)), publisher=pub,
                          control=QueueControl(), scan_depth=8, device=dev)
    fk.reset_counts()
    k.reset_counts()
    n = gsrv.run()
    four = fk.counts()
    launched_only(four, dict(fft_launches=2 * n, ifft_launches=2 * n), "generic server")
    launched_only(k.counts(), {}, "generic server (fused kernels)")
    contiguous(pub.ref_seqs, 1, "generic server")
    out["generic"] = dict(**GENERIC, scan_depth=8, blocks_served=n, launches=four,
                          status=synced_line(gsrv, N_CH, "generic server"))

    # Farrow on the card against the same call on the CPU.
    g = torch.Generator().manual_seed(16)
    x = torch.complex(torch.randn((N_CH, 4 * L), generator=g),
                      torch.randn((N_CH, 4 * L), generator=g))
    adv = (torch.linspace(-40.5, 37.25, 4 * L)[None]
           + torch.rand((N_CH, 1), generator=g) * 10)
    farrow_err = (farrow_fractional_delay(x.to(dev), adv.to(dev)).cpu()
                  - farrow_fractional_delay(x, adv)).abs().max().item()
    if not farrow_err <= FARROW_ATOL:
        raise AssertionError(f"Farrow on the card off the CPU by {farrow_err}")
    out["farrow_max_abs_err_vs_cpu"] = farrow_err
    return out, launches, four, cap, want


# Phase 17: the native ring server (native.py + csrc/coherent_host.cc) at
# N = 21, L = 8192.
RING_PACE = 2.048e6 / L      # blocks/s of a real-time array (250)
RING_SLOTS = 256              # holds 8 batches of 32 (the JAX default 16 cannot hold one)
RING_SLABS = 9                # slabs of the capture file: 2,286 blocks, ~824 MB
RING_SERVE = 128              # (c): blocks a bit-equality run serves
RING_WARM = 64                # (d), (e): blocks before the ring is drained
RING_WINDOW = 1000            # (d), (e): blocks a timed window
RING_FILL_MAX = 64            # (d): most blocks left in the ring at a window's end
MOCK_SERIALS = ["MOCKREF0", "MOCK0001", "MOCK0002", "MOCK0003"]
MOCK_SLOTS = 1024             # 2 s of the mock's ~500 blocks/s


class TeePublisher:
    """Publishes through ``inner`` (the native publisher) and keeps
    ``io/wire.pack_frame`` of the first ``keep_first`` frames' outputs,
    numbered as the native publisher numbers them."""

    def __init__(self, inner, keep_first):
        self.inner, self.keep_first = inner, keep_first
        self.first, self.count = [], 0

    def publish(self, iq_i8, seqnums, phases=None):
        from coherent_rtlsdr_tpu_torch.io.wire import pack_frame

        if len(self.first) < self.keep_first:
            self.first.append(pack_frame(self.count, seqnums, iq_i8))
        self.count += 1
        return self.inner.publish(iq_i8, seqnums, phases)


class RingReader:
    """A thread popping a receive ring as fast as frames arrive: keeps the
    first ``keep`` blocks with their seqnums and counts the rest."""

    def __init__(self, ring, keep):
        import threading

        self.ring, self.keep = ring, keep
        self.first, self.count = [], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            out = self.ring.pop_n(timeout_ms=100)
            if out is None:
                continue
            if len(self.first) < self.keep:
                self.first.append(out[:2])
            self.count += 1

    def stop(self):
        self._stop.set()
        self._thread.join()


def free_tcp_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ring_file_dir(nbytes):
    """/dev/shm when it holds the file with room to spare, else the temp
    directory; raises when neither does."""
    import shutil
    import tempfile

    for d in ("/dev/shm", tempfile.gettempdir()):
        if os.path.isdir(d) and shutil.disk_usage(d).free > 1.5 * nbytes:
            return d
    raise AssertionError(f"no directory with {1.5 * nbytes / 1e9:.1f} GB free for the ring file")


def ring_server(cfg, path, depth, dev, publisher):
    """A paced file producer (RING_PACE blocks/s, no loop) into a fresh
    ring of RING_SLOTS, a RingSource and a server at ``depth`` reading it:
    (server, ring, producer). The producer starts last, so the ring fills
    only while the server runs."""
    from coherent_rtlsdr_tpu_torch import native
    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.signal.sources import RingSource

    ring = native.NativeBlockRing(RING_SLOTS, (N_CH + 1) * 2 * L, n_seq=N_CH + 1)
    srv = CoherentServer(cfg, RingSource(ring, N_CH, L), publisher=publisher,
                         control=QueueControl(), scan_depth=depth, device=dev)
    producer = native.NativeProducer.file(ring, path, rate_blocks_per_s=RING_PACE)
    return srv, ring, producer


def host_state():
    """The CPU seconds this process has used, the CPUs it may run on, and
    the memory the kernel reports available and in shmem (GB)."""
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":")
            if key in ("MemAvailable", "Shmem"):
                mem[key + "_gb"] = int(value.split()[0]) / 2 ** 20
    return dict(cpu_s=time.process_time(), cpus=len(os.sched_getaffinity(0)), **mem)


def paced_window(srv, ring, producer, k, where):
    """RING_WARM blocks, the ring drained, then a timed window of
    RING_WINDOW blocks with the loop's host time split by part (source =
    ``RingSource.next_block``, its wait for the producer included), and
    what the process got from its host over the window. Returns the
    window's record and the launch counts of both runs."""
    k.reset_counts()
    if srv.run(max_blocks=RING_WARM) != RING_WARM:
        raise AssertionError(f"{where}: warm-up published too few frames")
    drained = srv.source.drain()
    drops0 = ring.dropped
    before = host_state()
    host = host_breakdown(srv, RING_WINDOW)
    after = host_state()
    fill_end, drops = ring.fill, ring.dropped - drops0
    counts = k.counts()
    producer_at_eof = not producer.running
    producer.stop()
    wall_s = host["wall_ms_per_block"] * host["blocks"] / 1e3
    launched_only_kernels(counts, RING_WARM + host["blocks"], where)
    return dict(window_blocks=host["blocks"], window_s=wall_s,
                samples_per_s=host["blocks"] * N_CH * L / wall_s, drained_before=drained,
                ring_drops=drops, ring_drops_total=ring.dropped, ring_fill_end=fill_end,
                keeps_real_time=(ring.dropped == 0 and fill_end <= RING_FILL_MAX
                                 and host["blocks"] == RING_WINDOW),
                producer_at_eof=producer_at_eof, host_ms_per_block=host,
                host=dict(after, cpu_s=after["cpu_s"] - before["cpu_s"]),
                status=srv.status().splitlines()[0]), counts


def mock_dongles(dev, k, tmp):
    """(f): the mock librtlsdr behind RtlSource, 3 signal channels at
    L = 8192, fused, 64 blocks at scan depth 1, with an HwDriftRelief whose
    pulse must reach the mock's set_sample_freq_correction_f log. ``tmp``
    must allow executables (/dev/shm may not)."""
    import subprocess

    import numpy as np

    from coherent_rtlsdr_tpu_torch import native
    from coherent_rtlsdr_tpu_torch.io.hwcontrol import MAX_CORR, SCALE, HwDriftRelief
    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
    from coherent_rtlsdr_tpu_torch.signal.sources import RtlSource

    so = os.path.join(tmp, "libmock_rtlsdr.so")
    mock_src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                            "mock_librtlsdr.c")
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", so, mock_src], check=True,
                   timeout=120)
    if not native.rtlsdr_load(so):
        raise AssertionError("the mock librtlsdr did not load")
    log = os.path.join(tmp, "mock_calls.log")
    os.environ["MOCK_RTLSDR_LOG"] = log
    n = len(MOCK_SERIALS) - 1
    cfg = PipelineConfig(n_channels=n, block_len=L, fft_impl="fused", lag_method="phase_zoom")
    src = RtlSource.start(MOCK_SERIALS, block_len=L, ring_slots=MOCK_SLOTS, fs=2.048e6,
                          fcenter=1024e6)
    try:
        pub = RecordingPublisher()
        srv = CoherentServer(cfg, src, publisher=pub, control=QueueControl(), device=dev)
        relief = HwDriftRelief(src.capture, fs=2.048e6, threshold=8.0)
        ticks = []
        tick = relief.tick
        relief.tick = lambda delays, now=None: ticks.append(len(delays)) or tick(delays, now)
        relief.tick([0.0, 100.0, 0.0])   # dongle 2 mid-dwell as the loop starts
        srv.hw_relief = relief
        k.reset_counts()
        served = srv.run(max_blocks=64)
        counts = k.counts()
        status = srv.status().splitlines()
    finally:
        src.stop()
        os.environ.pop("MOCK_RTLSDR_LOG", None)
    launched_only_kernels(counts, served, "mock dongles")
    seqs = np.array(pub.seqnums, np.int64)   # [T, 1 + n]: ref, then each dongle
    with open(log) as f:
        hits = [tuple(int(v) for v in (i, a)) for i, fn, a in (ln.split() for ln in f)
                if fn == "set_sample_freq_correction_f"]
    # the pulse on dongle 2 (tanh law, nano-units), then its restore
    pulse = MAX_CORR * np.tanh(100.0 / SCALE) * 1e9
    at = next((i for i, (dongle, v) in enumerate(hits)
               if dongle == 2 and abs(v - pulse) <= 1000), None)
    rec = dict(serials=MOCK_SERIALS, blocks_served=served, launches=counts,
               ring_drops=src._ring.dropped, channel_drops=src.capture.dropped,
               seqnums_contiguous=bool((np.diff(seqs[:, 1:], axis=0) == 1).all()),
               first_seqnums=seqs[0].tolist(), relief_ticks_from_loop=len(ticks) - 1,
               correction_calls=hits,
               capture_status=[line for line in status if line.startswith("capture:")])
    if not (served == 64 and rec["seqnums_contiguous"] and rec["ring_drops"] == 0
            and rec["channel_drops"] == 0 and seqs.shape == (64, 1 + n)
            and len(ticks) >= 2 and at is not None and (2, 0) in hits[at + 1:]):
        raise AssertionError(f"mock dongles: {rec}")
    return rec, counts


def phase_ring_server(dev, smi, k, cap16, want16):
    """Phase 17: (a) the native library's build and libzmq; (b) phase 16's
    capture (same seed, more slabs) as a raw ring file; (c) frames of a
    file producer -> ring -> RingSource -> server chain at scan depth 1 and
    32, bit-equal to phase 16's on the same bytes; (d) the chain paced at
    RING_PACE blocks/s, a timed window at each depth; (e) the depth-32
    window again through the native publisher, its frames read back by the
    port's own ZMQ producer; (f) mock dongles. Each part prints its own
    line. Returns the fused kernel launches of every part."""
    import shutil
    import subprocess
    import tempfile

    import numpy as np

    from coherent_rtlsdr_tpu_torch import native
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig

    cfg = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                         lag_method="phase_zoom")
    launches = dict.fromkeys(k.counts(), 0)

    def add(counts):
        for name, v in counts.items():
            launches[name] += v

    # (a) Build and environment.
    built_before = native.library_path().exists()
    t0 = time.perf_counter()
    lib_path = native.build()
    build_s = time.perf_counter() - t0
    zmq_loads = bool(native._load().chost_zmq_available())
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        listed = "libzmq.so.5" in subprocess.run([ldconfig, "-p"], capture_output=True,
                                                 text=True, timeout=30).stdout
    except OSError:
        listed = None
    try:
        import zmq

        pyzmq = dict(version=zmq.__version__, libzmq=zmq.zmq_version())
    except ImportError:
        pyzmq = None
    emit(dict(phase="ring_server", part="build", card=smi, native_build_s=build_s,
              was_built_before=built_before, library=os.path.basename(lib_path),
              chost_zmq_available=zmq_loads, ldconfig_lists_libzmq_so_5=listed, pyzmq=pyzmq))

    # (b) The capture file: raw ring blocks (ref first), phase 16's
    # capture continued, no loop.
    t0 = time.perf_counter()
    cap, _ = render_capture(RING_SLABS * SERVER_SLAB, dev)
    if not (np.array_equal(cap.sig_u8[:cap16.n_blocks], cap16.sig_u8)
            and np.array_equal(cap.ref_u8[:cap16.n_blocks], cap16.ref_u8)):
        raise AssertionError("ring capture: its first blocks are not phase 16's bytes")
    block_bytes = (N_CH + 1) * 2 * L
    tmp = tempfile.mkdtemp(prefix="ring_server_", dir=ring_file_dir(cap.n_blocks * block_bytes))
    path = os.path.join(tmp, "capture.raw")
    try:
        with open(path, "wb") as f:
            for t in range(cap.n_blocks):
                f.write(cap.ref_u8[t].tobytes())
                f.write(cap.sig_u8[t].tobytes())
        del cap
        emit(dict(phase="ring_server", part="capture_file", card=smi, blocks=RING_SLABS * SERVER_SLAB,
                  block_bytes=block_bytes, file_bytes=os.path.getsize(path), dir=os.path.dirname(tmp),
                  render_and_write_s=time.perf_counter() - t0))

        # (c) Bit-equality at scan depth 1 and 32 (paced, so the ring never
        # fills while the server serves RING_SERVE blocks).
        rec = dict(phase="ring_server", part="bit_equal", card=smi, N=N_CH, L=L,
                   pace_blocks_per_s=RING_PACE, ring_slots=RING_SLOTS)
        for depth in (1, 32):
            where = f"ring server K={depth}"
            pub = RecordingPublisher(keep_first=SERVER_WARM)
            srv, ring, producer = ring_server(cfg, path, depth, dev, pub)
            k.reset_counts()
            served = srv.run(max_blocks=RING_SERVE)
            counts = k.counts()
            producer.stop()
            if served != RING_SERVE or ring.dropped:
                raise AssertionError(f"{where}: served {served}, ring drops {ring.dropped}")
            launched_only_kernels(counts, served, where)
            add(counts)
            contiguous(pub.ref_seqs, 1, where)
            if not (np.array(pub.seqnums)[:, 1:] == np.arange(1, served + 1)[:, None]).all():
                raise AssertionError(f"{where}: channel seqnums are not the file's block count")
            rec[f"scan_depth_{depth}"] = dict(
                blocks_served=served, ring_drops=ring.dropped, launches=counts,
                bit_equal_to_phase_16=bit_equal(pub.first, want16, where),
                status=synced_line(srv, N_CH, where), frames=check_frames(pub.last, N_CH, where))
        emit(rec)

        # (d) Paced real time: a timed window at each depth.
        rec = dict(phase="ring_server", part="paced", card=smi, N=N_CH, L=L,
                   pace_blocks_per_s=RING_PACE, realtime_samples_per_s=REALTIME_SAMPLES_S,
                   ring_slots=RING_SLOTS, publisher="in-process (pack_frame)")
        for depth in (1, 32):
            srv, ring, producer = ring_server(cfg, path, depth, dev, RecordingPublisher())
            window, counts = paced_window(srv, ring, producer, k, f"paced ring server K={depth}")
            add(counts)
            rec[f"scan_depth_{depth}"] = window
        d32 = rec["scan_depth_32"]
        emit(rec)
        if not d32["keeps_real_time"]:
            raise AssertionError(f"paced ring server K=32 fell behind: {d32}")

        # (e) The native publisher, bound on a loopback address, read back
        # by a native ZMQ producer into a receive ring.
        if not zmq_loads:
            emit(dict(phase="ring_server", part="native_publisher", card=smi, libzmq=None))
        else:
            data = f"tcp://127.0.0.1:{free_tcp_port()}"
            debug = f"tcp://127.0.0.1:{free_tcp_port()}"
            rx_ring = native.NativeBlockRing(1024, block_bytes, n_seq=N_CH + 1)
            rx = native.NativeProducer.zmq(rx_ring, data)   # connects until the bind
            reader = RingReader(rx_ring, keep=SERVER_WARM)
            native_pub = native.NativePublisher(data, debug)
            tee = TeePublisher(native_pub, keep_first=SERVER_WARM)
            try:
                time.sleep(0.5)   # the subscription reaches the publisher
                srv, ring, producer = ring_server(cfg, path, 32, dev, tee)
                window, counts = paced_window(srv, ring, producer, k, "native publisher K=32")
                add(counts)
            finally:
                native_pub.close()   # while the receiver still reads
                deadline = time.time() + 10
                while reader.count < tee.count and time.time() < deadline:
                    time.sleep(0.01)
                rx.stop()
                reader.stop()
            from coherent_rtlsdr_tpu_torch.io.wire import pack_frame

            got = [pack_frame(i, seqs.astype(np.uint32),
                              (buf ^ np.uint8(0x80)).view(np.int8).reshape(N_CH + 1, L, 2))
                   for i, (buf, seqs) in enumerate(reader.first)]
            equal = sum(g == w for g, w in zip(got, tee.first))
            rec = dict(phase="ring_server", part="native_publisher", card=smi, libzmq=True,
                       address=data, published=tee.count, received=reader.count,
                       receive_ring_drops=rx_ring.dropped, rejected=rx.rejected,
                       frames_compared=len(got), frames_equal_to_pack_frame=equal,
                       worker_publish_ms_per_block=window["host_ms_per_block"]["worker_publish"],
                       in_process_worker_publish_ms_per_block=d32["host_ms_per_block"][
                           "worker_publish"],
                       window=window)
            emit(rec)
            if not (len(got) == SERVER_WARM and equal == SERVER_WARM
                    and window["ring_drops_total"] == 0):
                raise AssertionError(f"native publisher: {rec}")

        # (f) Mock dongles.
        mock_tmp = tempfile.mkdtemp(prefix="mock_rtlsdr_")
        try:
            rec_f, counts = mock_dongles(dev, k, mock_tmp)
        finally:
            shutil.rmtree(mock_tmp, ignore_errors=True)
        add(counts)
        emit(dict(phase="ring_server", part="mock_dongles", card=smi, N=len(MOCK_SERIALS) - 1,
                  L=L, **rec_f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# Phase 18: the array models (coherent_rtlsdr_tpu_torch/models) at the
# production array, and the MUSIC client app fed by the fused server.
MODEL_ROWS, MODEL_COLS = 7, 3   # the published 7x3 URA of the 21 signal channels
MODEL_GRID = 100                # heatmap2d's 100 x 100 (u, v) scan: G = 10^4
MODEL_FRAMES = 16               # T = 16 frames x L = 131,072 snapshots
# Two plane waves apart by a null of each axis' array factor (2/3 in u for
# 3 columns, 4/7 in v for 7 rows), so neither biases the other's Bartlett peak.
MODEL_SOURCES = ((0.3, -0.25), (0.3 - 2 / 3, -0.25 + 4 / 7))
MODEL_SNR_DB = 20.0
ULA_THETAS = (-0.35, 0.5)       # rad: ESPRIT / root-MUSIC on a 21-element ULA
COARRAY_SPARSE = ((0, 0), (1, 0), (4, 0), (6, 0))   # tests/test_models.py:121
COARRAY_US = (-0.72, -0.35, 0.0, 0.38, 0.7)
COARRAY_T, COARRAY_GRID = 4000, 241
NEARFIELD_N = 32                # 32^3 candidate points
NEARFIELD_AT = (15, 10, 20)     # the emitter's grid point: (1.5, 0.5, 4.0) wavelengths
MODEL_RUNS = 5                  # timed runs a function, on the card and on the CPU
# Card against a float64 numpy reference on the same snapshots: each
# spectrum in dB where the reference lies within 30 dB of its peak.
SPECTRUM_DB_BAR = 0.1
SPECTRUM_WITHIN_DB = 30.0
# The steering matrix (float32 phases up to ~25 rad, so ~2e-6 of rounding)
# and the covariance (float32 sums over T) against float64, the latter
# relative to its largest entry: the CPU tests' bars.
STEERING_ATOL = 1e-5
COV_REL_BAR = 1e-5
DOA_ATOL_RAD = 1e-3             # ESPRIT / root-MUSIC against the truth
CLIENT_SERVE = 128              # blocks served once the client is connected
CLIENT_ITERS = 4                # heatmaps ([0] .. [3]) before the client is stopped


def db_error(got, want):
    """Max |dB difference| where ``want`` lies within SPECTRUM_WITHIN_DB of
    its peak."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    near = want >= want.max() * 10 ** (-SPECTRUM_WITHIN_DB / 10)
    return float(np.abs(10 * np.log10(got[near] / want[near])).max())


def reference_spectra(X, pos, uv, n_sources, diag_load=1e-3):
    """The covariance, the steering matrix and MUSIC, Bartlett and MVDR in
    float64 numpy on the host: the plain formulas of models/beamform.py."""
    import numpy as np

    X = X.astype(np.complex128)
    X = X - X.mean(-1, keepdims=True)
    R = X @ X.conj().T / X.shape[-1]
    n = R.shape[0]
    A = np.exp(2j * np.pi * uv.astype(np.float64) @ pos.astype(np.float64).T)
    norm = (np.abs(A) ** 2).sum(-1)
    _, vecs = np.linalg.eigh(R)
    music = norm / (np.abs(A @ vecs[:, : n - n_sources].conj()) ** 2).sum(-1)
    bartlett = np.real((A.conj() * (A @ R.T)).sum(-1)) / norm
    Rl = R + diag_load * np.real(np.trace(R)) / n * np.eye(n)
    mvdr = 1.0 / np.real((A.T.conj() * np.linalg.solve(Rl, A.T)).sum(0))
    return dict(R=R, A=A, music=music, bartlett=bartlett, mvdr=mvdr)


def peaks_at(P, ax, truths, where):
    """Within 5 grid steps of each truth, the largest value of the
    [grid, grid] spectrum lies within one step of it, and the global peak
    lies within one step of one of them. Returns the peaks' (u, v)."""
    import numpy as np

    step = float(ax[1] - ax[0])
    found = []
    for u0, v0 in truths:
        iu = np.flatnonzero(np.abs(ax - u0) <= 5 * step)
        iv = np.flatnonzero(np.abs(ax - v0) <= 5 * step)
        j = np.unravel_index(np.argmax(P[np.ix_(iv, iu)]), (len(iv), len(iu)))
        u, v = float(ax[iu[j[1]]]), float(ax[iv[j[0]]])
        if not (abs(u - u0) <= step and abs(v - v0) <= step):
            raise AssertionError(f"{where}: the peak near ({u0}, {v0}) is at ({u}, {v})")
        found.append((u, v))
    i = int(np.argmax(P))
    u, v = float(ax[i % len(ax)]), float(ax[i // len(ax)])
    if not any(abs(u - u0) <= step and abs(v - v0) <= step for u0, v0 in truths):
        raise AssertionError(f"{where}: the global peak ({u}, {v}) is at no source")
    return found


def host_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def phase_models(dev):
    """Phase 18 (a): each model function on the card at the production
    array against a float64 numpy reference or the truth, the co-array
    lags twice bit-equal, and each function timed on the card (CUDA
    events) and at device="cpu" (host clock), medians of MODEL_RUNS."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.models import (
        bartlett_spectrum,
        coarray_music_spectrum,
        esprit_doa,
        music_heatmap,
        music_spectrum,
        mvdr_spectrum,
        root_music_doa,
        sample_covariance,
        steering_vectors,
        ula_positions,
        ura_positions,
        uv_grid,
    )
    from coherent_rtlsdr_tpu_torch.models.beamform import _noise_subspace
    from coherent_rtlsdr_tpu_torch.models.coarray import coarray_covariance_lags
    from coherent_rtlsdr_tpu_torch.models.localize import make_xyz_grid, ml_localize, nearfield_music

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(18)
    T = MODEL_FRAMES * L
    out = dict(N=MODEL_ROWS * MODEL_COLS, array=f"{MODEL_ROWS}x{MODEL_COLS} URA",
               G=MODEL_GRID ** 2, T=T)

    def cgauss(*shape):
        z = torch.randn((2, *shape), generator=gen, device=dev)
        return torch.complex(z[0], z[1]) / 2 ** 0.5

    def snapshots(a, n_snap, noise_amp):
        """a [N, K] float64 host steering, unit-power sources: [N, n_snap]
        complex64 on the card."""
        A = torch.from_numpy(a.astype(np.complex64)).to(dev)
        return A @ cgauss(a.shape[1], n_snap) + noise_amp * cgauss(a.shape[0], n_snap)

    noise_amp = 10 ** (-MODEL_SNR_DB / 20)

    # The 7x3 URA, two plane waves: the three spectra and the heatmap.
    pos = ura_positions(MODEL_ROWS, MODEL_COLS)
    truths = np.asarray(MODEL_SOURCES)
    X = snapshots(np.exp(2j * np.pi * pos.astype(np.float64) @ truths.T), T, noise_amp)
    uv, ax_t = uv_grid(MODEL_GRID, device=dev)
    ax = ax_t.cpu().numpy()
    R = sample_covariance(X)
    A = steering_vectors(pos, uv)
    got = dict(music=music_heatmap(X, pos, len(truths), MODEL_GRID).reshape(-1),
               bartlett=bartlett_spectrum(R, A), mvdr=mvdr_spectrum(R, A))
    want = reference_spectra(X.cpu().numpy(), pos, uv.cpu().numpy(), len(truths))
    steering_err = float(np.abs(A.cpu().numpy() - want["A"]).max())
    cov_rel_err = float(np.abs(R.cpu().numpy() - want["R"]).max() / np.abs(want["R"]).max())
    if not (steering_err <= STEERING_ATOL and cov_rel_err <= COV_REL_BAR):
        raise AssertionError(f"against float64: steering off by {steering_err}, covariance "
                             f"by {cov_rel_err} of its largest entry")
    spectra = {}
    for name, P in got.items():
        P = P.cpu().numpy()
        err = db_error(P, want[name])
        if not err <= SPECTRUM_DB_BAR:
            raise AssertionError(f"{name} on the card off the float64 reference by {err} dB")
        spectra[name] = dict(max_db_err=err, peaks=peaks_at(P.reshape(MODEL_GRID, MODEL_GRID),
                                                            ax, truths, name))
    out.update(sources_uv=truths.tolist(), snr_db=MODEL_SNR_DB, steering_max_abs_err=steering_err,
               covariance_max_rel_err=cov_rel_err, spectra=spectra)

    # ESPRIT and root-MUSIC on a 21-element ULA (host-side numpy on R).
    n_ula = MODEL_ROWS * MODEL_COLS
    thetas = np.asarray(ULA_THETAS)
    Xu = snapshots(np.exp(2j * np.pi * 0.5 * np.arange(n_ula)[:, None] * np.sin(thetas)[None]),
                   T, noise_amp)
    Ru = sample_covariance(Xu, subtract_mean=False)
    doas = {}
    for name, fn in (("esprit", esprit_doa), ("root_music", root_music_doa)):
        est = fn(Ru, len(thetas))
        err = float(np.abs(est - np.sort(thetas)).max())
        if not err <= DOA_ATOL_RAD:
            raise AssertionError(f"{name}: {est} against {np.sort(thetas)} rad")
        doas[name] = dict(rad=est.tolist(), max_abs_err_rad=err)
    out.update(ula_n=n_ula, thetas_rad=thetas.tolist(), doa=doas)

    # Co-array MUSIC: five sources on four sensors (tests/test_models.py:121).
    sparse = np.asarray(COARRAY_SPARSE)
    us = np.asarray(COARRAY_US)
    Xs = snapshots(np.exp(2j * np.pi * 0.5 * sparse[:, :1] * us[None]), COARRAY_T, 0.03 * 2 ** 0.5)
    Rs = sample_covariance(Xs, subtract_mean=False)
    uv_c, ax_c = uv_grid(COARRAY_GRID, device=dev)
    axc = ax_c.cpu().numpy()
    Pc = coarray_music_spectrum(Rs, sparse, (7, 1), uv_c, len(us)).cpu().numpy()
    u_profile = Pc.reshape(COARRAY_GRID, COARRAY_GRID).max(axis=0)
    coarray_peaks = []
    for u_true in us:
        window = (axc > u_true - 0.08) & (axc < u_true + 0.08)
        outside = ~((axc > u_true - 0.15) & (axc < u_true + 0.15))
        u_pk = float(axc[window][int(np.argmax(u_profile[window]))])
        if not (u_profile[window].max() > 3.0 * np.median(u_profile[outside])
                and abs(u_pk - u_true) < 0.05):
            raise AssertionError(f"co-array MUSIC: no peak at u = {u_true} (found {u_pk})")
        coarray_peaks.append(u_pk)
    # The lag averages twice, bit-equal: on the sparse array and on the URA
    # as integer grid positions (441 sensor pairs).
    ura_grid = np.rint(pos / 0.5).astype(np.int64)
    lags_equal = {}
    for name, RR, gp in (("sparse", Rs, sparse), ("ura", R, ura_grid)):
        a, _ = coarray_covariance_lags(RR, gp)
        b, _ = coarray_covariance_lags(RR, gp)
        lags_equal[name] = bool(torch.equal(a, b))
    if not all(lags_equal.values()):
        raise AssertionError(f"co-array lags differ between two runs: {lags_equal}")
    out["coarray"] = dict(sensors=len(sparse), sources=len(us), box=[7, 1],
                          peaks_u=coarray_peaks, lags_bit_equal=lags_equal)

    # Near-field: the emitter on a 32^3 grid point, found by MUSIC and ML.
    n3 = (NEARFIELD_N,) * 3
    grid = make_xyz_grid((0.0, 3.1), (0.0, 1.55), (2.0, 5.1), n3, device=dev)
    k_true = int(np.ravel_multi_index(NEARFIELD_AT, n3))
    xyz = grid[k_true].cpu().numpy().astype(np.float64)
    p3 = np.concatenate([pos, np.zeros((len(pos), 1))], axis=-1).astype(np.float64)
    d = np.linalg.norm(xyz[None] - p3, axis=-1)
    Xn = snapshots(np.exp(-2j * np.pi * (d - d[0]))[:, None], T, noise_amp)
    k_music = int(torch.argmax(nearfield_music(Xn, pos, grid)))
    xyz_hat, spec = ml_localize(Xn, pos, grid)
    if not (k_music == k_true and int(torch.argmax(spec)) == k_true
            and torch.equal(xyz_hat, grid[k_true])):
        raise AssertionError(f"near-field: MUSIC at {k_music}, ML at "
                             f"{int(torch.argmax(spec))}, the emitter at {k_true}")
    out["nearfield"] = dict(grid=list(n3), G=grid.shape[0], emitter_xyz=xyz.tolist(),
                            music_index=k_music, ml_index=k_true)

    # Each function timed on the card and on the CPU, on the same inputs.
    cpu = torch.device("cpu")
    ins = {d_: dict(X=X.to(d_), R=R.to(d_), A=A.to(d_), uv=uv.to(d_), Ru=Ru.to(d_),
                    Rs=Rs.to(d_), uv_c=uv_c.to(d_), Xn=Xn.to(d_), grid=grid.to(d_))
           for d_ in (dev, cpu)}
    Rl = {d_: i["R"] + 1e-3 * i["R"].diagonal().sum().real / n_ula
          * torch.eye(n_ula, dtype=i["R"].dtype, device=d_) for d_, i in ins.items()}
    calls = {
        "steering_vectors": lambda i, d_: steering_vectors(pos, i["uv"]),
        "sample_covariance": lambda i, d_: sample_covariance(i["X"]),
        "eigh": lambda i, d_: torch.linalg.eigh(i["R"]),
        "music_spectrum": lambda i, d_: music_spectrum(i["R"], i["A"], len(truths)),
        "bartlett_spectrum": lambda i, d_: bartlett_spectrum(i["R"], i["A"]),
        "solve": lambda i, d_: torch.linalg.solve(Rl[d_], i["A"].T),
        "mvdr_spectrum": lambda i, d_: mvdr_spectrum(i["R"], i["A"]),
        "music_heatmap": lambda i, d_: music_heatmap(i["X"], pos, len(truths), MODEL_GRID),
        "esprit_doa": lambda i, d_: esprit_doa(i["Ru"], len(thetas)),
        "root_music_doa": lambda i, d_: root_music_doa(i["Ru"], len(thetas)),
        "coarray_covariance_lags": lambda i, d_: coarray_covariance_lags(i["R"], ura_grid),
        "coarray_music_spectrum": lambda i, d_: coarray_music_spectrum(
            i["Rs"], sparse, (7, 1), i["uv_c"], len(us)),
        "nearfield_music": lambda i, d_: nearfield_music(i["Xn"], pos, i["grid"]),
        "ml_localize": lambda i, d_: ml_localize(i["Xn"], pos, i["grid"]),
    }
    ms = {}
    for name, fn in calls.items():
        card = lambda: fn(ins[dev], dev)
        host = lambda: fn(ins[cpu], cpu)
        card(), host()   # warm-up
        card_runs = [cuda_ms(card) for _ in range(MODEL_RUNS)]
        cpu_runs = [host_ms(host) for _ in range(MODEL_RUNS)]
        ms[name] = dict(card=statistics.median(card_runs), cpu=statistics.median(cpu_runs))
    out.update(ms=ms, seconds=time.perf_counter() - t_phase)
    return out


class LineReader:
    """A thread reading a child's text stdout into a list of lines."""

    def __init__(self, stream):
        import threading

        self.lines, self.last_at = [], time.time()
        self._stream = stream
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for line in self._stream:
            self.lines.append(line)
            self.last_at = time.time()

    @property
    def text(self):
        return "".join(self.lines)

    def join(self):
        self._thread.join(timeout=10)


def wait_until(cond, seconds, proc):
    deadline = time.time() + seconds
    while time.time() < deadline and not cond() and proc.poll() is None:
        time.sleep(0.05)
    return cond()


def phase_music_client(dev, k, cap):
    """Phase 18 (b): the fused server (phase 16's capture and recipe, scan
    depth 32) publishes through pyzmq on a free loopback port; once it is
    21 / 21 synced, ``python3 -m coherent_rtlsdr_tpu_torch.apps.music_client
    --follow`` runs on the card as a child process; once it has connected,
    the server serves CLIENT_SERVE blocks; after CLIENT_ITERS heatmaps and
    the last iteration's files the client is stopped. Returns the record
    and the fused kernel launches."""
    import re
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import zmq
    from scipy.io import loadmat
    from zmq.utils.monitor import recv_monitor_message

    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.io.zmq_edge import FramePublisher
    from coherent_rtlsdr_tpu_torch.models import (
        music_spectrum,
        sample_covariance,
        steering_vectors,
        ura_positions,
        uv_grid,
    )
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
    from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

    t_phase = time.perf_counter()
    cfg = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                         lag_method="phase_zoom")
    data = f"tcp://127.0.0.1:{free_tcp_port()}"
    pub = FramePublisher(data_addr=data, debug_addr=f"tcp://127.0.0.1:{free_tcp_port()}")
    monitor = pub.data.get_monitor_socket(zmq.EVENT_HANDSHAKE_SUCCEEDED)
    srv = CoherentServer(cfg, FileSource(cap), publisher=pub, control=QueueControl(),
                         scan_depth=32, device=dev)
    tmp = tempfile.mkdtemp(prefix="music_client_")
    npy, mat = os.path.join(tmp, "heatmap.npy"), os.path.join(tmp, "heatmap.mat")
    err = open(os.path.join(tmp, "client.err"), "w+")
    proc = reader = None
    try:
        k.reset_counts()
        if srv.run(max_blocks=SERVER_WARM) != SERVER_WARM:
            raise AssertionError("music client's server: warm-up published too few frames")
        status = synced_line(srv, N_CH, "music client's server")
        t_start = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "coherent_rtlsdr_tpu_torch.apps.music_client", "-a", data,
             "--follow", "--frames", str(MODEL_FRAMES), "--rows", str(MODEL_ROWS), "--cols",
             str(MODEL_COLS), "--grid", str(MODEL_GRID), "-o", npy, "--mat", mat,
             "--timeout-ms", "120000"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=err, text=True)
        reader = LineReader(proc.stdout)
        if not monitor.poll(120_000):
            raise AssertionError("the music client never connected")
        recv_monitor_message(monitor)
        connect_s = time.perf_counter() - t_start
        time.sleep(0.5)   # its subscription reaches the publisher
        t0 = time.perf_counter()
        served = srv.run(max_blocks=CLIENT_SERVE)
        serve_s = time.perf_counter() - t0
        counts = k.counts()
        done = wait_until(lambda: f"[{CLIENT_ITERS - 1}] music spectrum" in reader.text, 120, proc)
        # The client then rests in its receive, the last iteration's files
        # written (the .mat after the .npy).
        settled = done and wait_until(
            lambda: (time.time() - reader.last_at > 1.5 and os.path.exists(mat)
                     and os.path.getmtime(mat) >= os.path.getmtime(npy)), 60, proc)
        alive = proc.poll() is None
        if not (served == CLIENT_SERVE and done and settled and alive):
            err.seek(0)
            raise AssertionError(f"music client: served {served}, iterations done {done}, "
                                 f"settled {settled}, alive {alive}; stdout "
                                 f"{reader.text[-1500:]!r}; stderr {err.read()[-3000:]!r}")
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if reader is not None:
            reader.join()
        err.close()
        pub.data.disable_monitor()
        monitor.close(0)
        pub.close()
    launched_only_kernels(counts, SERVER_WARM + CLIENT_SERVE, "music client's server")
    try:
        P = np.load(npy)
        m = loadmat(mat)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x = m["x"]   # [T, 21] complex64: heatmap2d2's matsave layout
    if not (np.array_equal(m["P"], P) and x.shape == (MODEL_FRAMES * L, N_CH)
            and x.dtype == np.complex64 and P.shape == (MODEL_GRID, MODEL_GRID)):
        raise AssertionError(f"music client's files: P {P.shape}, x {x.shape} {x.dtype}, "
                             f"P in the .mat equal: {np.array_equal(m['P'], P)}")
    # Every aligned channel carries the reference noise in phase with
    # channel 0: one source at broadside.
    uv_cpu, ax_t = uv_grid(MODEL_GRID, device="cpu")
    ax = ax_t.numpy()
    step = float(ax[1] - ax[0])
    i = int(P.argmax())
    peak = (float(ax[i % MODEL_GRID]), float(ax[i // MODEL_GRID]))
    if not (abs(peak[0]) <= step and abs(peak[1]) <= step):
        raise AssertionError(f"music client: peak at {peak}, not at broadside")
    # The same spectrum recomputed at device="cpu" on the .mat file's x.
    want = music_spectrum(sample_covariance(torch.from_numpy(np.ascontiguousarray(x.T))),
                          steering_vectors(ura_positions(MODEL_ROWS, MODEL_COLS), uv_cpu),
                          1).numpy().reshape(MODEL_GRID, MODEL_GRID)
    err_db = db_error(P, want)
    if not err_db <= SPECTRUM_DB_BAR:
        raise AssertionError(f"music client's spectrum off its CPU recomputation by {err_db} dB")
    its = [float(v) for v in re.findall(r"\] music spectrum ([\d.]+) ms on cuda", reader.text)]
    printed = re.findall(r"\[(\d+)\] peak at \(u, v\) = \(([-+.\d]+), ([-+.\d]+)\)", reader.text)
    return dict(address=data, status=status, client_connect_s=connect_s,
                served_blocks=served, serve_s=serve_s,
                server_frames_per_s=served / serve_s,
                server_samples_per_s=served * N_CH * L / serve_s,
                launches=counts, iterations=len(its),
                client_heatmap_ms=its, client_heatmap_ms_first=its[0],
                client_heatmap_ms_median_after_first=statistics.median(its[1:]),
                last_printed_peak=[int(printed[-1][0]), float(printed[-1][1]),
                                   float(printed[-1][2])],
                peak_uv=peak, grid_step=step, max_db_err_vs_cpu=err_db,
                seconds=time.perf_counter() - t_phase), counts


# Phase 19: the fused main path at L = 32768 (m = 256, W = 65536), N = 21,
# where a window runs on a cluster of four CTAs.
L19, M19 = 32768, 256
T19 = 64                             # align_offline blocks: 1,323 windows a call
SERVER19_WINDOW = {1: 64, 32: 128}   # blocks a timed window, by scan depth


def hold_rows_4_to_7(k, fk, raw, ref_raw, g, where):
    """Kernel table rows 4-7 against their plain versions on the same
    inputs: ``fused_apply_i8`` by the wire bars (advances of -1500.25 and
    1023.5 among the windows), the four-step forward and inverse on the
    channel windows of the bytes (hold_fourstep: FFT_PLAIN_REL, and
    FFT_LIB_REL against torch.fft), and the float pair on the planes of the
    same bytes (hold_float_measure, hold_float_apply)."""
    from coherent_rtlsdr_tpu_torch.ops.convert import i8_iq_to_c64

    T, n = raw.shape[:2]
    m = k.m
    adv = (torch.rand((T - 1, n), generator=g, device=raw.device) - 0.5) * 80.0
    adv[0, 0], adv[0, 1] = -1500.25, 1023.5
    ph = torch.rand((T - 1, n), generator=g, device=raw.device) * 6.283185307179586
    args = (adv, torch.cos(ph), torch.sin(ph))
    mx, share = compare_wire(k.apply_i8(raw, *args), k.apply_i8_plain(raw, *args),
                             where + " apply_i8")
    errs = dict(apply_i8_wire_max_lsb=mx, apply_i8_wire_share_gt1=share)
    sig = i8_iq_to_c64(raw.reshape(T, n, m * m // 2, 2))
    errs.update(hold_fourstep(fk, torch.cat([sig[:-1], sig[1:]], dim=-1).reshape(-1, m * m),
                              where))
    planes = planes_from_i8(raw, ref_raw, fk)
    errs.update(hold_float_measure(k, planes, where))
    errs.update(hold_float_apply(k, planes, adv, where))
    return errs


def phase19_kernels(dev, k):
    """Phase 19 (a): the four m = 256 kernels of the fused path against
    their plain versions at N = 21, T = 5 on random and correlated bytes,
    by phase 2's bars (fused_measure_i8 held alone on the reference
    kernel's R, as hold_measure holds fused_measure_i8_spec); then, on the
    same bytes, the entries of kernel table rows 4-7 against theirs
    (hold_rows_4_to_7)."""
    from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
    from coherent_rtlsdr_tpu_torch.kernels.fourstep import get_fourstep_kernel

    out = []
    fk = get_fourstep_kernel(M19 * M19, dev)
    g = torch.Generator(device=dev).manual_seed(M19)
    for kind, (raw, ref_raw) in small_blocks(M19, g, dev).items():
        where = f"m=256 {kind}"
        errs, want = hold_measure(k, raw, ref_raw, where)
        R, eref = k.measure_ref(ref_raw)
        lag_err, rel = compare_measure(fused_cuda.measure_i8(k, raw, R, eref),
                                       k.measure_i8_plain(raw, R, eref), where + " measure_i8")
        errs.update(measure_i8_lag_max_abs_err=lag_err, measure_i8_rel_err=rel)
        adv = (torch.rand((4, N_CH), generator=g, device=dev) - 0.5) * 80.0
        adv[0, 0], adv[0, 1] = -1500.25, 1023.5
        ph = torch.rand((4, N_CH), generator=g, device=dev) * 6.283185307179586
        errs.update(hold_apply(k, (want[5], want[6], adv, torch.cos(ph), torch.sin(ph)), where))
        out.append(dict(m=M19, N=N_CH, T=5, inputs=kind, **errs,
                        rows_4_to_7=hold_rows_4_to_7(k, fk, raw, ref_raw, g, where)))
    return out


def phase19_server(dev, smi, cfg, k):
    """Phase 19 (e): a capture rendered by render_capture's recipe at
    L = 32768, served by FileSource to the fused server at scan depth 1 and
    32: samples/s over 3 timed windows (median), one more window with the
    host parts timed, at depth 32 one run under torch.profiler; 21 / 21
    synced, contiguous ref seqnums, phase 16's frame bars on the last 16
    frames, the first frames bit-equal to the packed runner's on the same
    bytes, one launch of each kernel a block and no plain run. Returns
    (the record, the launches of all its runs, the capture)."""
    need = 2 * SERVER_WARM + (SERVER_WINDOWS + 1) * SERVER19_WINDOW[32]
    t0 = time.perf_counter()
    cap, _ = render_capture(need, dev, block_len=L19)
    render_s = time.perf_counter() - t0
    want = runner_frames(cfg, cap, SERVER_WARM, dev)
    launches = dict.fromkeys(k.counts(), 0)
    out = dict(capture_blocks=cap.n_blocks, render_s=render_s)
    for depth in (1, 32):
        where = f"server L=32768 K={depth}"
        srv, pub, windows = timed_server(cfg, cap, depth, k, dev, window=SERVER19_WINDOW)
        rates = [n * N_CH * L19 / sec for sec, n in windows]
        rec = dict(window_blocks=SERVER19_WINDOW[depth], window_s=[sec for sec, _ in windows],
                   samples_per_s=rates, samples_per_s_median=statistics.median(rates),
                   realtime=statistics.median(rates) >= REALTIME_SAMPLES_S,
                   status=synced_line(srv, N_CH, where),
                   host_ms_per_block=host_breakdown(srv, SERVER19_WINDOW[depth]))
        served = SERVER_WARM + sum(n for _, n in windows) + SERVER19_WINDOW[depth]
        if depth == 32:
            prof = device_profile(lambda: srv.run(max_blocks=SERVER_WARM))
            served += SERVER_WARM
            rec["profile"] = {key: prof[key] for key in
                              ("wall_ms", "device_busy_ms", "idle_share", "top_ms",
                               "fused_kernel_ms")}
        counts = k.counts()
        launched_only_kernels(counts, served, where)
        for name, v in counts.items():
            launches[name] += v
        contiguous(pub.ref_seqs, 1, where)
        rec.update(blocks_served=served, launches=counts,
                   **graph_counts(srv, served, depth, where),
                   frames=check_frames(pub.last, N_CH, where, block_len=L19),
                   bit_equal_to_runner=bit_equal(pub.first, want, where))
        out[f"scan_depth_{depth}"] = rec
    if not out["scan_depth_32"]["realtime"]:
        raise AssertionError(f"server L=32768 K=32 below real time: "
                             f"{out['scan_depth_32']['samples_per_s']}")
    return out, launches, cap


def phase_l32768(dev, smi):
    """Phase 19: the fused main path at L = 32768 (m = 256), N = 21, through
    the four cluster kernels: (a) each against its plain version, and rows
    4-7 against theirs; (b) align_offline at T = 64 (1,323 windows), 1 + 1 + 1 launches
    a call and no plain run, samples/s over 7 runs against 43.0e6, and the
    recompute measure (measure_ref, then fused_measure_i8) on the same
    bytes, its scalars equal to the handoff's; (c) quality against
    synthetic truth by phase 4's bars; (d) each kernel against its plain
    version at (b)'s shapes, timed in turns (phase 6's scheme), and two
    calls of each under torch.profiler; (e) the server (phase19_server).
    Each part emits one line. Returns the data of the kernels line's four
    m = 256 entries of the fused path, and (e)'s capture."""
    from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
    from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig

    cfg = PipelineConfig(n_channels=N_CH, block_len=L19, fft_impl="fused",
                         lag_method="phase_zoom")
    k = get_fused_kernels(2 * L19, dev)
    base = dict(phase="l32768", card=smi, N=N_CH, L=L19, m=M19)

    # (a)
    results = phase19_kernels(dev, k)
    emit(dict(base, part="kernel_vs_plain", results=results))

    # (b)
    raw, ref_raw, cap = synth_raw(T19, L19, N_CH, seed=19, dev=dev)
    sig_u8 = cap.sig_u8.reshape(T19, N_CH, 2 * L19)
    ref_u8 = cap.ref_u8.reshape(T19, 2 * L19)
    offline_run(cfg, sig_u8, ref_u8)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = None

    def drive_offline():
        nonlocal res
        res = offline_run(cfg, sig_u8, ref_u8)

    k.reset_counts()
    ms_runs = [cuda_ms(drive_offline) for _ in range(7)]
    counts_offline = k.counts()
    launched_only_kernels(counts_offline, 7, "offline L=32768")
    ms_offline = statistics.median(ms_runs)
    rate = (T19 - 1) * N_CH * L19 / ms_offline * 1e3
    truth_err = float(abs(res.delay[0].cpu().numpy() - cap.truth.delays).max())
    if not (tuple(res.wire.shape) == (T19 - 1, N_CH, 2 * L19)
            and torch.isfinite(res.lag).all() and truth_err < 0.05
            and res.mag.min().item() > 0.5 and rate >= REALTIME_SAMPLES_S):
        raise AssertionError(f"offline L=32768: {rate} samples/s, max |delay - truth| "
                             f"{truth_err}, min mag {res.mag.min().item()}")
    k.reset_counts()
    rec = k.measure_i8(raw, ref_raw)
    torch.cuda.synchronize()
    counts_rec = k.counts()
    launched_only(counts_rec, dict(measure_ref_launches=1, measure_i8_launches=1),
                  "recompute measure L=32768")
    spec = k.measure_i8_spec(raw, ref_raw)
    rec_vs_spec = {}
    for name, a, b in zip(("lag", "z_re", "z_im", "mag", "papr"), rec, spec):
        err = (a - b).abs()
        rec_vs_spec[f"{name}_max_abs_diff"] = err.max().item()
        if not (err <= HANDOFF_SCALAR_TOL * (1 + b.abs())).all():
            raise AssertionError(f"recompute measure L=32768: {name} off the handoff's by "
                                 f"{err.max().item()}")
    del rec, spec
    emit(dict(base, part="offline", T=T19, smoothing="global", ms_median=ms_offline,
              ms_runs=ms_runs, samples_per_s=rate, realtime_x=rate / REALTIME_SAMPLES_S,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              max_abs_delay_minus_truth=truth_err, launches=counts_offline,
              recompute_measure=dict(launches=counts_rec, vs_handoff=rec_vs_spec)))

    # (c)
    _, _, q_cap = synth_raw(16, L19, N_CH, seed=7, dev=dev)
    q = offline_run(cfg, q_cap.sig_u8.reshape(16, N_CH, 2 * L19),
                    q_cap.ref_u8.reshape(16, 2 * L19))
    z = (q.aligned * q.ref.conj()[:, None, :]).sum(-1)
    errs_deg = torch.rad2deg(torch.angle(z))[2:].double()
    phase_rms = errs_deg.pow(2).mean().sqrt().item()
    lag_err = q.delay[2:].double().cpu() - torch.from_numpy(q_cap.truth.delays).double()[None]
    lag_rms = lag_err.pow(2).mean().sqrt().item()
    emit(dict(base, part="quality", T=16, phase_err_deg_rms=phase_rms,
              residual_lag_rms_samples=lag_rms, bars=[PHASE_ERR_DEG, LAG_ERR_SAMPLES]))
    if not (phase_rms <= PHASE_ERR_DEG and lag_rms <= LAG_ERR_SAMPLES):
        raise AssertionError(f"quality L=32768: {phase_rms} deg, {lag_rms} samples")
    del q, z

    # (d)
    errs, want = hold_measure(k, raw, ref_raw, "m=256 offline shapes")
    adv = res.delay.contiguous()
    pre, pim = res.phase.real.contiguous(), res.phase.imag.contiguous()
    errs.update(hold_apply(k, (want[5], want[6], adv, pre, pim), "m=256 offline shapes"))
    del want
    R, eref = k.measure_ref(ref_raw)
    errs["measure_i8_lag_max_abs_err"], _ = compare_measure(
        fused_cuda.measure_i8(k, raw, R, eref), k.measure_i8_plain(raw, R, eref),
        "m=256 offline shapes measure_i8")
    meas = k.measure_spec(raw, R, eref)
    fns = {
        "measure_ref": lambda: k.measure_ref(ref_raw),
        "measure_ref_plain": lambda: k.measure_ref_plain(ref_raw),
        "measure": lambda: k.measure_spec(raw, R, eref),
        "measure_plain": lambda: k.measure_spec_plain(raw, R, eref),
        "measure_i8": lambda: fused_cuda.measure_i8(k, raw, R, eref),
        "measure_i8_plain": lambda: k.measure_i8_plain(raw, R, eref),
        "apply": lambda: k.apply_spec_i8(meas[5], meas[6], adv, pre, pim),
        "apply_plain": lambda: k.apply_spec_i8_plain(meas[5], meas[6], adv, pre, pim),
    }
    ms, runs = timed_interleaved(fns, ("measure_ref", "measure", "measure_i8", "apply"),
                                 ("_plain", ""))
    # Device times from one profiled run of two calls of each kernel, None
    # where the profiler shows no such kernel. The run opens with ~4 ms of
    # sleep kernels: here, late in this script, the first kernels of a
    # profiled run went unrecorded (on the H100: four one-kernel runs came
    # back empty, and a run of eight calls lost its first three).
    def profiled():
        for _ in range(8):
            torch.cuda._sleep(1_000_000)
        for name in ("measure_ref", "measure", "measure_i8", "apply"):
            for _ in range(2):
                fns[name]()

    prof = device_profile(profiled)["fused_kernel_ms"]
    kernel_names = {"measure_ref": "fused::measure_ref_cluster_kernel",
                    "measure": "fused::measure_cluster_kernel<true>",
                    "measure_i8": "fused::measure_cluster_kernel<false>",
                    "apply": "fused::apply_spec_cluster_kernel"}
    device_ms = {name: prof[kn] / 2 if kn in prof else None
                 for name, kn in kernel_names.items()}
    emit(dict(base, part="kernel_times", T=T19, ms=ms, runs=runs, device_ms=device_ms,
              kernel_vs_plain=errs))
    del meas, R, eref, res, raw, ref_raw, cap, sig_u8, ref_u8

    # (e)
    rec_e, counts_server, cap_e = phase19_server(dev, smi, cfg, k)
    emit(dict(base, part="server", fft_impl="fused", **rec_e))

    launches = {name: counts_offline[name] + counts_rec[name] + counts_server[name]
                for name in counts_offline}
    for name in ("measure_ref", "measure_spec", "measure_i8", "apply_spec_i8"):
        if not launches[f"{name}_launches"] > 0:
            raise AssertionError(f"phase 19: {name} at m = 256 was never launched on the path")
    worst = lambda key: max(max(r[key] for r in results), errs[key])
    return dict(launches=launches, ms=ms, device_ms=device_ms,
                err=dict(measure_ref=worst("R_max_abs_err"),
                         measure=worst("lag_max_abs_err"),
                         measure_i8=worst("measure_i8_lag_max_abs_err"),
                         apply=worst("wire_max_lsb"))), cap_e


SERVER20_BLOCKS = 64   # generic server blocks at scan depth 8


def phase_generic_l32768(dev, smi, cap19):
    """Phase 20: the generic path, FusedSpectral and the recompute pair at
    L = 32768 (m = 256), N = 21, on the cluster kernels of kernel table
    rows 4-7: (a) each against its plain version at T = 5; (b) the generic
    offline engine (pallas, phase_slope) at T = 64, 2 + 2 four-step launches
    a call and no plain run, samples/s over 7 runs against 43.0e6 beside
    xla, peak memory, a profile, and quality at T = 16 by phase 10's bars; (c)
    FusedSpectral at T = 64 by its launch counts and the float kernels'
    bars, timed over 3 calls; (d) the recompute pair on (b)'s bytes by
    phase 14's contract; (e) each kernel timed against its plain version
    in turns and twice under torch.profiler; (f) the generic server on
    phase 19's capture ``cap19`` (scan depth 8). Each part emits one line.
    Returns the data of the kernels line's four m = 256 entries of rows
    4-7."""
    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.kernels.backend import FusedSpectral
    from coherent_rtlsdr_tpu_torch.kernels.fourstep import get_fourstep_kernel
    from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
    from coherent_rtlsdr_tpu_torch.ops.convert import u8_to_c64
    from coherent_rtlsdr_tpu_torch.ops.phase import unit_phasor
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
    from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

    gcfg = PipelineConfig(n_channels=N_CH, block_len=L19, **GENERIC)
    k = get_fused_kernels(2 * L19, dev)
    fk = get_fourstep_kernel(2 * L19, dev)
    base = dict(phase="generic_l32768", card=smi, N=N_CH, L=L19, m=M19)

    # (a) Other bytes than phase 19 (a)'s hold of the same kernels.
    g = torch.Generator(device=dev).manual_seed(M19 + 20)
    results = [dict(T=5, inputs=kind, **hold_rows_4_to_7(k, fk, raw, ref_raw, g,
                                                          f"phase 20 m=256 {kind}"))
               for kind, (raw, ref_raw) in small_blocks(M19, g, dev, seed=M19 + 20).items()]
    emit(dict(base, part="kernel_vs_plain", results=results))

    # (b)
    raw, ref_raw, cap = synth_raw(T19, L19, N_CH, seed=20, dev=dev)
    sig_u8 = cap.sig_u8.reshape(T19, N_CH, 2 * L19)
    ref_u8 = cap.ref_u8.reshape(T19, 2 * L19)
    offline_run(gcfg, sig_u8, ref_u8)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gres = None

    def drive_generic():
        nonlocal gres
        gres = offline_run(gcfg, sig_u8, ref_u8)

    fk.reset_counts()
    k.reset_counts()
    g_runs = [cuda_ms(drive_generic) for _ in range(7)]
    counts_off = fk.counts()
    launched_only(counts_off, dict(fft_launches=14, ifft_launches=14), "generic offline L=32768")
    launched_only(k.counts(), {}, "generic offline L=32768 (fused kernels)")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms_g = statistics.median(g_runs)
    samples = (T19 - 1) * N_CH * L19
    rate = samples / ms_g * 1e3
    g_err = float(abs(gres.delay[0].cpu().numpy() - cap.truth.delays).max())
    if not (tuple(gres.aligned.shape) == (T19 - 1, N_CH, L19)
            and torch.isfinite(gres.lag).all() and g_err < GEN_LAG_MAX
            and gres.mag.min().item() > 0.5 and rate >= REALTIME_SAMPLES_S):
        raise AssertionError(f"generic offline L=32768: {rate} samples/s, max |delay - truth| "
                             f"{g_err}, min mag {gres.mag.min().item()}")
    del gres
    xcfg = PipelineConfig(n_channels=N_CH, block_len=L19, fft_impl="xla",
                          lag_method="phase_slope")
    offline_run(xcfg, sig_u8, ref_u8)   # warm-up
    x_runs = [cuda_ms(lambda: offline_run(xcfg, sig_u8, ref_u8)) for _ in range(3)]
    _, _, q_cap = synth_raw(16, L19, N_CH, seed=7, dev=dev)
    gq = offline_run(gcfg, q_cap.sig_u8.reshape(16, N_CH, 2 * L19),
                     q_cap.ref_u8.reshape(16, 2 * L19))
    z = (gq.aligned * gq.ref.conj()[:, None, :]).sum(-1)
    q_deg = torch.rad2deg(torch.angle(z))[2:].double()
    q_lag = gq.delay[2:].double().cpu() - torch.from_numpy(q_cap.truth.delays).double()[None]
    quality = dict(T=16, phase_err_deg_rms=q_deg.pow(2).mean().sqrt().item(),
                   residual_lag_rms_samples=q_lag.pow(2).mean().sqrt().item(),
                   phase_err_deg_max=q_deg.abs().max().item(),
                   lag_err_max_samples=q_lag.abs().max().item(),
                   bars=[GEN_PHASE_MAX_DEG, GEN_LAG_MAX])
    if not (quality["phase_err_deg_max"] <= GEN_PHASE_MAX_DEG
            and quality["lag_err_max_samples"] <= GEN_LAG_MAX):
        raise AssertionError(f"generic quality L=32768: {quality}")
    del gq, z, q_cap
    emit(dict(base, part="offline", T=T19, **GENERIC, smoothing="global", ms_median=ms_g,
              ms_runs=g_runs, samples_per_s=rate, realtime_x=rate / REALTIME_SAMPLES_S,
              peak_mem_gb=peak, max_abs_delay_minus_truth=g_err, launches=counts_off,
              xla_cufft=dict(ms_median=statistics.median(x_runs), ms_runs=x_runs,
                             samples_per_s=samples / statistics.median(x_runs) * 1e3),
              quality=quality, profile=device_profile(lambda: offline_run(gcfg, sig_u8, ref_u8))))

    # (c)
    sig_c = u8_to_c64(sig_u8.reshape(T19, N_CH, L19, 2))
    ref_c = u8_to_c64(ref_u8.reshape(T19, L19, 2))
    fsp = FusedSpectral(2 * L19, dev)
    fctx = fest = fy = None

    def drive_fsp():
        nonlocal fctx, fest, fy
        fy = None   # the previous call's output, freed before the next one
        fctx = fsp.prepare(sig_c, ref_c)
        fest = fsp.measure(fctx, "phase_zoom")
        fy = fsp.correct(fctx, fest.lag)

    fk.reset_counts()
    k.reset_counts()
    drive_fsp()
    torch.cuda.synchronize()
    counts_fsp = {**fk.counts(), **k.counts()}
    launched_only(fk.counts(), dict(fft_launches=1), "FusedSpectral L=32768 (four-step)")
    launched_only(k.counts(), dict(measure_launches=1, apply_launches=1),
                  "FusedSpectral L=32768 (float measure/apply)")
    f_err = float(abs(fest.lag.median(dim=0).values.cpu().numpy() - cap.truth.delays).max())
    if not (tuple(fy.shape) == (T19 - 1, N_CH, L19)
            and torch.isfinite(torch.view_as_real(fy)).all()
            and f_err < GEN_LAG_MAX and fest.mag.min().item() > 0.5):
        raise AssertionError(f"FusedSpectral L=32768 output wrong: lag {f_err}, "
                             f"min mag {fest.mag.min().item()}")
    fsp_runs = [cuda_ms(drive_fsp) for _ in range(3)]
    del fy
    errs = hold_float_measure(k, fctx, "FusedSpectral L=32768")
    errs.update(hold_float_apply(k, fctx, fest.lag, "FusedSpectral L=32768"))
    emit(dict(base, part="fused_spectral", T=T19, ms_median=statistics.median(fsp_runs),
              ms_runs=fsp_runs, launches={name: n for name, n in counts_fsp.items() if n},
              max_abs_median_lag_minus_truth=f_err, mag_min=fest.mag.min().item(),
              kernel_vs_plain=dict(errs)))

    # (d)
    k.reset_counts()
    rec = k.measure_i8(raw, ref_raw)
    pc = unit_phasor(torch.complex(rec[1], -rec[2]))
    p_re, p_im = pc.real.contiguous(), pc.imag.contiguous()
    wire_r = k.apply_i8(raw, rec[0], p_re, p_im)
    torch.cuda.synchronize()
    counts_rec = k.counts()
    launched_only(counts_rec, dict(measure_ref_launches=1, measure_i8_launches=1,
                                   apply_i8_launches=1), "recompute pair L=32768")
    rec_deg = wire_phase_deg(wire_r, ref_raw)
    if not (wire_r.shape == (T19 - 1, *raw.shape[1:])
            and all(torch.isfinite(x).all() for x in rec) and rec[3].min().item() > 0.5
            and rec_deg.abs().max().item() <= RECOMPUTE_PHASE_MAX_DEG):
        raise AssertionError(f"recompute pair L=32768 output wrong: min mag "
                             f"{rec[3].min().item()}, max |phase| "
                             f"{rec_deg.abs().max().item()} deg")
    spec = k.measure_i8_spec(raw, ref_raw)
    contract = hold_handoff_contract(rec, wire_r, spec[:5],
                                     k.apply_spec_i8(spec[5], spec[6], rec[0], p_re, p_im))
    del spec
    mx, share = compare_wire(wire_r, k.apply_i8_plain(raw, rec[0], p_re, p_im),
                             "apply_i8 L=32768 offline shapes")
    errs.update(apply_i8_wire_max_lsb=mx, apply_i8_wire_share_gt1=share)
    emit(dict(base, part="recompute_pair", T=T19, launches=counts_rec,
              mag_min=rec[3].min().item(), wire_phase_deg_max=rec_deg.abs().max().item(),
              wire_phase_deg_rms=rec_deg.pow(2).mean().sqrt().item(),
              handoff_contract=contract, apply_i8_vs_plain=dict(wire_max_lsb=mx,
                                                                 wire_share_gt1=share)))
    del wire_r

    # (e)
    w_sig = torch.cat([sig_c[:-1], sig_c[1:]], dim=-1).reshape(-1, 2 * L19)
    B = w_sig.shape[0]
    errs.update(hold_fourstep(fk, w_sig, "four-step L=32768 offline shapes"))
    Xw = fk.fft(w_sig)
    adv = fest.lag.contiguous()
    fns = {
        "fft": lambda: fk.fft(w_sig), "fft_plain": lambda: fk.fft_plain(w_sig),
        "fft_lib": lambda: torch.fft.fft(w_sig),
        "ifft": lambda: fk.ifft(Xw), "ifft_plain": lambda: fk.ifft_plain(Xw),
        "ifft_lib": lambda: torch.fft.ifft(w_sig),
        "apply_i8": lambda: k.apply_i8(raw, rec[0], p_re, p_im),
        "apply_i8_plain": lambda: k.apply_i8_plain(raw, rec[0], p_re, p_im),
        "measure": lambda: k.measure(*fctx), "measure_plain": lambda: k.measure_plain(*fctx),
        "apply": lambda: k.apply(fctx.pre, fctx.pim, adv),
        "apply_plain": lambda: k.apply_plain(fctx.pre, fctx.pim, adv),
    }
    ms, runs = timed_interleaved({n: f for n, f in fns.items() if n.startswith(("fft", "ifft"))},
                                 ("fft", "ifft"), ("_plain", "", "_lib"), reps=FFT_REPS)
    ms_k, runs_k = timed_interleaved(
        {n: f for n, f in fns.items() if not n.startswith(("fft", "ifft"))},
        ("apply_i8", "measure", "apply"), ("_plain", ""))
    ms.update(ms_k)
    runs.update(runs_k)
    kernel_names = {"fft": "fourstep::fourstep_cluster_kernel<false>",
                    "ifft": "fourstep::fourstep_cluster_kernel<true>",
                    "apply_i8": "fused::apply_i8_cluster_kernel",
                    "measure": "fused::measure_planes_cluster_kernel",
                    "apply": "fused::apply_planes_cluster_kernel"}

    def profiled():   # opens with sleep kernels, as phase 19 (d) explains
        for _ in range(8):
            torch.cuda._sleep(1_000_000)
        for name in kernel_names:
            for _ in range(2):
                fns[name]()

    prof = device_profile(profiled)["fused_kernel_ms"]
    device_ms = {name: prof[kn] / 2 if kn in prof else None for name, kn in kernel_names.items()}
    emit(dict(base, part="kernel_times", T=T19, B=B, ms=ms, runs=runs, fft_reps=FFT_REPS,
              device_ms=device_ms, kernel_vs_plain=errs,
              kernel_over_torch_fft=dict(fft=ms["fft"] / ms["fft_lib"],
                                         ifft=ms["ifft"] / ms["ifft_lib"])))
    del fns, Xw, w_sig, fctx, fest, rec, raw, ref_raw, cap, sig_c, ref_c, sig_u8, ref_u8

    # (f)
    where = "generic server L=32768"
    pub = RecordingPublisher()
    gsrv = CoherentServer(gcfg, FileSource(sub_capture(cap19, 0, SERVER20_BLOCKS)),
                          publisher=pub, control=QueueControl(), scan_depth=8, device=dev)
    fk.reset_counts()
    k.reset_counts()
    n = gsrv.run()
    counts_server = fk.counts()
    launched_only(counts_server, dict(fft_launches=2 * n, ifft_launches=2 * n), where)
    launched_only(k.counts(), {}, where + " (fused kernels)")
    if n != SERVER20_BLOCKS:
        raise AssertionError(f"{where}: published {n} of {SERVER20_BLOCKS} blocks")
    contiguous(pub.ref_seqs, 1, where)
    emit(dict(base, part="server", **GENERIC, scan_depth=8, blocks_served=n,
              launches=counts_server, status=synced_line(gsrv, N_CH, where),
              frames=check_frames(pub.last, N_CH, where, block_len=L19)))

    fwd = (counts_off["fft_launches"] + counts_fsp["fft_launches"]
           + counts_server["fft_launches"])
    inv = counts_off["ifft_launches"] + counts_server["ifft_launches"]
    worst = lambda key: max(max(r[key] for r in results), errs[key])
    return dict(
        B=B, ms=ms, device_ms=device_ms,
        launches=dict(apply_i8=counts_rec["apply_i8_launches"], fft=fwd + inv,
                      measure=counts_fsp["measure_launches"], apply=counts_fsp["apply_launches"]),
        err=dict(apply_i8=worst("apply_i8_wire_max_lsb"),
                 fft=max(worst("fwd_max_abs_err"), worst("inv_max_abs_err")),
                 measure=worst("lag_max_abs_err"), apply=worst("y_max_abs_err")))


# parallel/ (phase 21): tests/test_parallel.py's bars, the sharded runner
# against the unsharded engine on the same bytes.
PAR_T = 256                    # (a): the offline shapes of phase 3
PAR_T_SHARED = 64              # (b): blocks of the capture the ranks share
PAR_DELAY_ATOL = 1e-3          # samples, torch.fft path
PAR_DELAY_ATOL_FUSED = 1e-4    # samples, fused and four-step paths
PAR_MAG_ATOL = 1e-5
PAR_ALIGNED_ATOL = 1e-3
PAR_WIRE_LSB = 1
PAR_RUNS = 7
PAR_RANK_TIMEOUT_S = 240


def hold_parallel(got, want, where, delay_atol):
    """A sharded runner's outputs against the unsharded engine's on the same
    bytes: ``got`` / ``want`` map a name (wire, wire_ref, delay, mag,
    aligned) to a tensor; returns the largest differences."""
    bars = dict(wire=PAR_WIRE_LSB, wire_ref=0, delay=delay_atol, mag=PAR_MAG_ATOL,
                aligned=PAR_ALIGNED_ATOL)
    wide = lambda x: x.to(torch.complex128 if x.is_complex() else torch.float64)
    errs = {}
    for name, g in got.items():
        w = want[name]
        if tuple(g.shape) != tuple(w.shape):
            raise AssertionError(f"{where}: {name} shape {tuple(g.shape)}, want {tuple(w.shape)}")
        d = (wide(g) - wide(w)).abs().max().item()
        errs[f"{name}_max_abs_err"] = d
        if not d <= bars[name]:
            raise AssertionError(f"{where}: {name} differs by {d} (bar {bars[name]})")
    return errs


def timed_pair(sharded_fn, plain_fn, runs=PAR_RUNS):
    """Median ms of ``sharded_fn`` and of ``plain_fn`` (the unsharded call)
    over ``runs`` runs each, in turns, after a warm-up of each."""
    sharded_fn()
    plain_fn()
    t_s, t_u = [], []
    for i in range(runs):
        for fn, out in ((sharded_fn, t_s), (plain_fn, t_u))[:: 1 if i % 2 else -1]:
            out.append(cuda_ms(fn))
    return statistics.median(t_s), statistics.median(t_u), t_s, t_u


def host_ms_median(fn, runs=PAR_RUNS):
    """Median host time (ms) for ``fn()`` to return, each call started on
    an idle card: its enqueue cost, or more where it waits for the card."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_parallel_one_rank(dev, smi):
    """Phase 21 (a): parallel/ in a one-rank NCCL group in this process at
    N = 21, L = 8192, T = 256: make_channel_sharded_align and
    make_fused_time_sharded_align (fused), make_sharded_align (torch.fft)
    and make_auto_sharded_align (pallas, global and ema), each held to the
    unsharded engine on the same bytes, with its launch counts (1 + 1 + 1
    fused kernels, 2 + 2 four-step, no plain run), its ms over 7 runs
    beside the unsharded call's, and the host time of a call of each. The
    group is destroyed at the end."""
    import shutil
    import tempfile
    import threading

    import torch.distributed as dist

    from coherent_rtlsdr_tpu_torch.kernels.fourstep import get_fourstep_kernel
    from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
    from coherent_rtlsdr_tpu_torch.parallel import sharded
    from coherent_rtlsdr_tpu_torch.parallel.distributed import init_multihost
    from coherent_rtlsdr_tpu_torch.parallel.mesh import make_mesh
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, align_offline

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    init_multihost(f"file://{tmp}/store", 1, 0)
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"one rank with a card of its own took {backend}, want nccl")
        mesh = make_mesh(1, 1)
        _, _, cap = synth_raw(PAR_T, L, N_CH, seed=21, dev=dev)
        sig, ref = cap.sig_u8, cap.ref_u8                              # [T, N, L, 2], [T, L, 2]
        sig_f, ref_f = sig.reshape(PAR_T, N_CH, 2 * L), ref.reshape(PAR_T, 2 * L)
        fused = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                               lag_method="phase_zoom")
        xla = PipelineConfig(n_channels=N_CH, block_len=L)
        generic = PipelineConfig(n_channels=N_CH, block_len=L, **GENERIC)
        k = get_fused_kernels(2 * L, dev)
        k4 = get_fourstep_kernel(2 * L, dev)
        out = {}

        def run_case(name, fn, plain, counter, want_counts, hold, delay_atol, profiled=False):
            fn()
            counter.reset_counts()
            got = fn()
            counts = counter.counts()
            launched_only(counts, want_counts, f"parallel {name}")
            errs = hold_parallel(*hold(got), f"parallel {name}", delay_atol)
            ms_s, ms_u, runs_s, runs_u = timed_pair(fn, plain)
            out[name] = dict(ms=ms_s, unsharded_ms=ms_u, overhead_ms=ms_s - ms_u,
                             ms_runs=runs_s, unsharded_ms_runs=runs_u,
                             host_ms=host_ms_median(fn), unsharded_host_ms=host_ms_median(plain),
                             launches=counts, **errs)
            if profiled:   # one call of each: device busy against the wall
                out[name]["profile"] = {
                    side: {k: v for k, v in device_profile(f).items() if k != "fused_kernel_ms"}
                    for side, f in (("sharded", fn), ("unsharded", plain))}

        one = dict(measure_ref_launches=1, measure_spec_launches=1, apply_spec_i8_launches=1)
        res_f = align_offline(fused, sig_f, ref_f)
        chan = sharded.make_channel_sharded_align(fused, mesh)
        run_case("channel_fused", lambda: chan(sig_f, ref_f),
                 lambda: align_offline(fused, sig_f, ref_f), k, one,
                 lambda g: (dict(wire=g[0], delay=g[1], mag=g[2]),
                            dict(wire=res_f.wire, delay=res_f.delay, mag=res_f.mag)),
                 PAR_DELAY_ATOL_FUSED)
        ftime = sharded.make_fused_time_sharded_align(fused, mesh)
        run_case("fused_time", lambda: ftime(sig_f, ref_f),
                 lambda: align_offline(fused, sig_f, ref_f), k, one,
                 lambda g: (dict(wire=g[0][1:], wire_ref=g[1][1:], delay=g[2][1:], mag=g[3][1:]),
                            dict(wire=res_f.wire, wire_ref=res_f.wire_ref, delay=res_f.delay,
                                 mag=res_f.mag)),
                 PAR_DELAY_ATOL_FUSED, profiled=True)
        del res_f
        res_x = align_offline(xla, sig, ref)
        salign = sharded.make_sharded_align(xla, mesh)
        run_case("sharded_align_xla", lambda: salign(sig, ref),
                 lambda: align_offline(xla, sig, ref), k, {},
                 lambda g: (dict(aligned=g[0][1:], delay=g[2][1:], mag=g[3][1:]),
                            dict(aligned=res_x.aligned, delay=res_x.delay, mag=res_x.mag)),
                 PAR_DELAY_ATOL)
        del res_x
        for smoothing in ("global", "ema"):
            res_p = align_offline(generic, sig, ref, smoothing=smoothing)
            auto = sharded.make_auto_sharded_align(generic, mesh, smoothing)
            run_case(f"auto_pallas_{smoothing}", lambda: auto(sig, ref),
                     lambda: align_offline(generic, sig, ref, smoothing=smoothing), k4,
                     dict(fft_launches=2, ifft_launches=2),
                     lambda g: (dict(aligned=g.aligned, delay=g.delay, mag=g.mag),
                                dict(aligned=res_p.aligned, delay=res_p.delay, mag=res_p.mag)),
                     PAR_DELAY_ATOL_FUSED)
            del res_p
        # This process's Python threads beside the times: another thread
        # would compete for the interpreter lock, which each collective
        # releases.
        threads = [t.name for t in threading.enumerate()]
        emit(dict(phase="parallel", part="one_rank", card=smi, backend=backend, N=N_CH, L=L,
                  T=PAR_T, mesh=[1, 1], torch=torch.__version__, python_threads=threads,
                  results=out))
        return out
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def compute_mode():
    """``nvidia-smi``'s compute mode of the first card."""
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def parallel_rank(out_dir, rank, world):
    """One rank of phase 21 (b)'s time-sharded run (``chip_smoke.py
    --parallel-rank DIR RANK WORLD``): the fused time-sharded runner on a
    (WORLD, 1) mesh of ranks that share the card, on ``DIR/in.npz``; rank 0
    writes the gathered outputs and every rank its launch counts."""
    import numpy as np
    import torch.distributed as dist

    from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
    from coherent_rtlsdr_tpu_torch.parallel import sharded
    from coherent_rtlsdr_tpu_torch.parallel.distributed import init_multihost
    from coherent_rtlsdr_tpu_torch.parallel.mesh import gather_to_rank0, local_shard, make_mesh
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig

    rank, world = int(rank), int(world)
    init_multihost(f"file://{out_dir}/store", world, rank)
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        data = np.load(os.path.join(out_dir, "in.npz"))
        sig = torch.from_numpy(data["sig"]).to(dev)
        ref = torch.from_numpy(data["ref"]).to(dev)
        T, N = sig.shape[:2]
        cfg = PipelineConfig(n_channels=N, block_len=sig.shape[2] // 2, fft_impl="fused",
                             lag_method="phase_zoom")
        mesh = make_mesh(world, 1)
        run = sharded.make_fused_time_sharded_align(cfg, mesh)
        k = get_fused_kernels(sig.shape[2], dev)
        k.reset_counts()
        wire, wire_ref, delay, mag = run(local_shard(sig, mesh).contiguous(),
                                         local_shard(ref, mesh, channel_dim=None).contiguous())
        torch.cuda.synchronize()
        with open(os.path.join(out_dir, f"counts_{rank}.json"), "w") as f:
            json.dump(dict(backend=dist.get_backend(), device=str(dev), **k.counts()), f)
        got = {name: gather_to_rank0(x, mesh, channel_dim=cd) for name, x, cd in (
            ("wire", wire, 1), ("wire_ref", wire_ref, None), ("delay", delay, 1),
            ("mag", mag, 1))}
        if rank == 0:
            np.savez(os.path.join(out_dir, "gathered.npz"),
                     **{name: x.cpu().numpy() for name, x in got.items()})
    finally:
        dist.destroy_process_group()
    return 0


def run_children(cmds, where, cwd):
    """Run ``cmds`` as child processes at once, each within
    PAR_RANK_TIMEOUT_S; raises with the output of any that failed."""
    import subprocess

    procs = [subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=PAR_RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    failed = [f"{c}: exit {p.returncode}\n{o[-4000:]}" for c, p, o in zip(cmds, procs, outs)
              if p.returncode]
    if failed:
        raise AssertionError(f"{where}: " + "\n".join(failed))
    return time.perf_counter() - t0, outs


def phase_parallel_shared_card(dev, smi):
    """Phase 21 (b): ranks that share the card, over gloo, as child
    processes: ``align_offline --mesh 3 --fft-impl fused`` on a 21-channel
    capture npz against the unsharded app's npz, and the fused time-sharded
    runner on a (2, 1) mesh against the unsharded engine. Skipped, and
    said so, when the card is in an exclusive compute mode."""
    import shutil
    import tempfile

    import numpy as np

    from coherent_rtlsdr_tpu_torch.apps import align_offline as align_app
    from coherent_rtlsdr_tpu_torch.io.streamio import Capture, save_capture
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, align_offline

    mode = compute_mode()
    if "exclusive" in mode.lower():
        emit(dict(phase="parallel", part="shared_card", card=smi, compute_mode=mode,
                  ran=False, why="the card is in an exclusive compute mode: ranks cannot share it"))
        return None
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shared_")
    try:
        T = PAR_T_SHARED
        _, _, cap = synth_raw(T, L, N_CH, seed=22, dev=dev)
        sig = cap.sig_u8.cpu().numpy()
        ref = cap.ref_u8.cpu().numpy()
        seq = np.broadcast_to(np.arange(T, dtype=np.uint32)[:, None], (T, N_CH + 1)).copy()
        src = os.path.join(tmp, "capture.npz")
        save_capture(src, Capture(sig_u8=sig, ref_u8=ref, seqnums=seq, fs=2.048e6,
                                  fcenter=868e6))
        app = [sys.executable, "-m", "coherent_rtlsdr_tpu_torch.apps.align_offline", src,
               "--fft-impl", "fused"]
        app_s, _ = run_children([app + ["--mesh", "3", "-o", os.path.join(tmp, "mesh.npz")]],
                                "align_offline --mesh 3", root)
        if align_app.main([src, "--fft-impl", "fused", "-o", os.path.join(tmp, "one.npz")]):
            raise AssertionError("the unsharded align_offline app failed")
        t_, o_ = (np.load(os.path.join(tmp, f)) for f in ("mesh.npz", "one.npz"))
        if sorted(t_.files) != ["aligned_i8", "delay", "fs", "mag", "ref_i8"]:
            raise AssertionError(f"align_offline --mesh 3 wrote {sorted(t_.files)}")
        app_errs = hold_parallel(
            {"wire": torch.from_numpy(t_["aligned_i8"]), "wire_ref": torch.from_numpy(t_["ref_i8"]),
             "delay": torch.from_numpy(t_["delay"]), "mag": torch.from_numpy(t_["mag"])},
            {"wire": torch.from_numpy(o_["aligned_i8"]), "wire_ref": torch.from_numpy(o_["ref_i8"]),
             "delay": torch.from_numpy(o_["delay"]), "mag": torch.from_numpy(o_["mag"])},
            "align_offline --mesh 3", PAR_DELAY_ATOL_FUSED)

        np.savez(os.path.join(tmp, "in.npz"), sig=sig.reshape(T, N_CH, 2 * L),
                 ref=ref.reshape(T, 2 * L))
        ranks_s, _ = run_children(
            [[sys.executable, os.path.abspath(__file__), "--parallel-rank", tmp, str(r), "2"]
             for r in range(2)], "fused time-sharded (2, 1)", root)
        counts = []
        for r in range(2):
            with open(os.path.join(tmp, f"counts_{r}.json")) as f:
                counts.append(json.load(f))
        for r, c in enumerate(counts):
            if c["backend"] != "gloo":
                raise AssertionError(f"rank {r} of two sharing a card took {c['backend']}")
            launched_only({n: v for n, v in c.items() if n not in ("backend", "device")},
                          dict(measure_ref_launches=1, measure_spec_launches=1,
                               apply_spec_i8_launches=1), f"time-sharded rank {r}")
        g = np.load(os.path.join(tmp, "gathered.npz"))
        fused = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                               lag_method="phase_zoom")
        res = align_offline(fused, cap.sig_u8.reshape(T, N_CH, 2 * L),
                            cap.ref_u8.reshape(T, 2 * L))
        time_errs = hold_parallel(
            {n: torch.from_numpy(g[n][1:]) for n in ("wire", "wire_ref", "delay", "mag")},
            dict(wire=res.wire.cpu(), wire_ref=res.wire_ref.cpu(), delay=res.delay.cpu(),
                 mag=res.mag.cpu()), "fused time-sharded (2, 1)", PAR_DELAY_ATOL_FUSED)
        out = dict(compute_mode=mode, ran=True, N=N_CH, L=L, T=T,
                   app_mesh3=dict(wall_s=app_s, **app_errs),
                   time_sharded_2x1=dict(wall_s=ranks_s, launches=counts, **time_errs))
        emit(dict(phase="parallel", part="shared_card", card=smi, **out))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 22: the streaming server on a channel mesh (parallel/, serving).
RUNNER_ROUNDS = 16             # (a): runner calls alone, in turns
RUNNER_CALLS = 8               # calls a round (~90 launches each: the queue does not fill)
MESH_GENERIC_BLOCKS = 64       # the pallas mesh server, correctness only
MESH_GENERIC_DEPTH = 8
MESH_SHARED_RANKS = 3          # (b): ranks that share the card
MESH_SHARED_DELAY_ATOL = 1e-3  # (b): the checkpoint's delays against the unsharded server's


class DigestPublisher(RecordingPublisher):
    """A ``RecordingPublisher`` that also keeps a digest of every serialized
    frame, so two servers' whole streams compare byte for byte."""

    def __init__(self, keep_first=0):
        super().__init__(keep_first)
        self.digests = []

    def publish(self, iq_i8, seqnums, phases=None):
        import hashlib

        n = super().publish(iq_i8, seqnums, phases)
        self.digests.append(hashlib.blake2b(self.last[-1], digest_size=16).digest())
        return n


def op_breakdown(srv, n_blocks, top=16):
    """One more run of ``srv`` under torch.profiler (host activity only):
    the ``top`` operators by their own host time, each with its calls and
    its own and total host ms a block, on every thread of the process (the
    publisher worker's too). The profiler's own cost inflates each call, so
    these are shares, not times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        n = srv.run(max_blocks=n_blocks)
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    return dict(blocks=n, ops={e.key: dict(calls_per_block=e.count / n,
                                           self_ms_per_block=e.self_cpu_time_total / 1e3 / n,
                                           total_ms_per_block=e.cpu_time_total / 1e3 / n)
                               for e in rows})


def runner_call_ms(srvs, cap, rounds=RUNNER_ROUNDS, calls=RUNNER_CALLS):
    """The host ms of one depth-1 runner call (``srv._runners.run``) of each
    server of ``srvs`` (a dict), alone: no loop and no publisher thread.
    In turns, ``rounds`` times: ``calls`` calls on one staged block of the
    capture, timed to the host's return from the last (few enough that the
    launch queue does not fill, so the card's time stays out), then a
    synchronize; the ms a call of each round. Each call's new state is
    dropped, so every server goes on as it was."""
    blk = [(cap.sig_u8[0], cap.ref_u8[0], cap.seqnums[0])]
    out = {side: [] for side in srvs}
    for i in range(rounds):
        for side in list(srvs)[:: 1 if i % 2 == 0 else -1]:
            srv = srvs[side]
            sig, ref, seq = srv._stage(blk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                srv._runners.run(srv._st, sig, ref, True, seq)
            out[side].append((time.perf_counter() - t0) * 1e3 / calls)
            torch.cuda.synchronize()
    return {side: dict(ms_per_call=v, median=statistics.median(v)) for side, v in out.items()}


def same_stream(a, b, where):
    """Two DigestPublishers saw the same frames, byte for byte."""
    if len(a.digests) != len(b.digests) or a.digests != b.digests:
        first = next((i for i, (x, y) in enumerate(zip(a.digests, b.digests)) if x != y), None)
        raise AssertionError(f"{where}: {len(a.digests)} against {len(b.digests)} frames, "
                             f"first differing frame {first}")
    return len(a.digests)


def save_shared_capture(directory, dev):
    """Phase 21 (b)'s 21-channel capture (PAR_T_SHARED blocks, seed 22) as
    an npz in ``directory`` with the seqnums a server's ``FileSource``
    reads (a column a signal channel, from 1): (path, capture)."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.io.streamio import Capture, save_capture

    T = PAR_T_SHARED
    _, _, cap = synth_raw(T, L, N_CH, seed=22, dev=dev)
    seq = np.tile(np.arange(1, T + 1, dtype=np.uint32)[:, None], (1, N_CH))
    path = os.path.join(directory, "capture.npz")
    save_capture(path, Capture(sig_u8=cap.sig_u8.cpu().numpy(), ref_u8=cap.ref_u8.cpu().numpy(),
                               seqnums=seq, fs=2.048e6, fcenter=868e6))
    return path, cap


def phase_mesh_server(dev, smi, k, fk, cap, want):
    """Phase 22 (a): ``CoherentServer(mesh=make_mesh(1, 1))`` in a one-rank
    NCCL group in this process, on phase 16's capture, fused at scan depth
    1 and 32 in turns with the unsharded server: every frame byte-equal to
    the unsharded server's (and the first 64 to the packed runner's),
    21 / 21, phase 16's frame bars, one launch of each fused kernel a
    block and no plain run; samples/s as the median of 3 windows each, in
    turns, and the host ms a block by part of one more window each (depth
    32 must keep real time), and at depth 1 the host operators of one more
    window each under torch.profiler and the host ms of a runner call with
    no loop around it; then the ``pallas`` server on the mesh, 64
    blocks at depth 8, against the unsharded one, 2 + 2 four-step launches
    a block. Returns (the fused launches, the four-step launches)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.parallel.distributed import init_multihost
    from coherent_rtlsdr_tpu_torch.parallel.mesh import make_mesh
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
    from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    init_multihost(f"file://{tmp}/store", 1, 0)
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"one rank with a card of its own took {backend}, want nccl")
        mesh = make_mesh(1, 1)
        cfg = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                             lag_method="phase_zoom")
        launches = dict.fromkeys(k.counts(), 0)
        out = dict(phase="mesh_server", part="one_rank", card=smi, backend=backend, N=N_CH, L=L,
                   mesh=[1, 1], fft_impl="fused")
        sides = ("unsharded", "mesh")
        for depth in (1, 32):
            where = f"mesh server K={depth}"
            srv, pub = {}, {}
            for side in sides:
                pub[side] = DigestPublisher(keep_first=SERVER_WARM)
                srv[side] = CoherentServer(cfg, FileSource(cap), publisher=pub[side],
                                           control=QueueControl(), scan_depth=depth,
                                           mesh=mesh if side == "mesh" else None, device=dev)
            tally = {side: dict.fromkeys(k.counts(), 0) for side in sides}

            def counted(side, fn):
                k.reset_counts()
                result = fn()
                for name, v in k.counts().items():
                    tally[side][name] += v
                return result

            for side in sides:
                counted(side, lambda: srv[side].run(max_blocks=SERVER_WARM))
            windows = {side: [] for side in sides}
            for i in range(SERVER_WINDOWS):
                for side in sides[:: 1 if i % 2 == 0 else -1]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    n = counted(side, lambda: srv[side].run(max_blocks=SERVER_WINDOW[depth]))
                    windows[side].append((time.perf_counter() - t0, n))
            host = {side: counted(side, lambda: host_breakdown(srv[side], SERVER_WINDOW[depth]))
                    for side in sides}
            ops = calls = None
            if depth == 1:
                ops = {side: counted(side, lambda: op_breakdown(srv[side], SERVER_WINDOW[depth]))
                       for side in sides}
                calls = runner_call_ms(srv, cap)   # launches outside ``counted``: not tallied
            rec = {}
            for side in sides:
                served = len(pub[side].ref_seqs)
                launched_only_kernels(tally[side], served, f"{where} ({side})")
                contiguous(pub[side].ref_seqs, 1, f"{where} ({side})")
                rates = [n * N_CH * L / sec for sec, n in windows[side]]
                rec[side] = dict(window_s=[sec for sec, _ in windows[side]],
                                 samples_per_s=rates,
                                 samples_per_s_median=statistics.median(rates),
                                 realtime=statistics.median(rates) >= REALTIME_SAMPLES_S,
                                 host_ms_per_block=host[side], blocks_served=served,
                                 **({} if ops is None else dict(host_ops=ops[side],
                                                                runner_call=calls[side])),
                                 launches=tally[side],
                                 status=synced_line(srv[side], N_CH, f"{where} ({side})"),
                                 frames=check_frames(pub[side].last, N_CH, f"{where} ({side})"))
                for name, v in tally[side].items():
                    launches[name] += v
            rec["mesh"]["bit_equal_to_runner"] = bit_equal(pub["mesh"].first, want, where)
            rec["mesh"]["bit_equal_to_unsharded"] = same_stream(pub["mesh"], pub["unsharded"],
                                                                where)
            srv["mesh"].close()
            if depth == 32 and not rec["mesh"]["realtime"]:
                raise AssertionError(f"{where}: {rec['mesh']['samples_per_s_median']} samples/s, "
                                     f"under real time ({REALTIME_SAMPLES_S})")
            out[f"scan_depth_{depth}"] = rec

        # The generic server (pallas) on the mesh, against the unsharded one.
        gcfg = PipelineConfig(n_channels=N_CH, block_len=L, **GENERIC)
        four = dict(fft_launches=0, ifft_launches=0)
        gpub = {}
        for side in sides:
            gpub[side] = DigestPublisher()
            gsrv = CoherentServer(gcfg, FileSource(sub_capture(cap, 0, MESH_GENERIC_BLOCKS)),
                                  publisher=gpub[side], control=QueueControl(),
                                  scan_depth=MESH_GENERIC_DEPTH,
                                  mesh=mesh if side == "mesh" else None, device=dev)
            fk.reset_counts()
            k.reset_counts()
            n = gsrv.run()
            counts = fk.counts()
            launched_only(counts, dict(fft_launches=2 * n, ifft_launches=2 * n),
                          f"generic mesh server ({side})")
            launched_only(k.counts(), {}, f"generic mesh server ({side}, fused kernels)")
            for name in four:
                four[name] += counts[name]
            if side == "mesh":
                out["generic"] = dict(**GENERIC, scan_depth=MESH_GENERIC_DEPTH, blocks_served=n,
                                      launches=counts,
                                      status=synced_line(gsrv, N_CH, "generic mesh server"),
                                      frames=check_frames(gpub[side].last, N_CH,
                                                          "generic mesh server"))
                gsrv.close()
        out["generic"]["bit_equal_to_unsharded"] = same_stream(gpub["mesh"], gpub["unsharded"],
                                                               "generic mesh server")
        out["seconds"] = time.perf_counter() - t_phase
        emit(out)
        return launches, four
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mesh_server_shared_card(dev, smi):
    """Phase 22 (b): ``coherent_server --mesh 3`` (three gloo ranks on the
    card, started by the app) on phase 21 (b)'s capture at scan depth 32,
    publishing through pyzmq to a SUB socket here: the last 16 frames by
    phase 16's bars, and its checkpoint 21 / 21 synced with delays within
    1e-3 of the unsharded server's on the same capture. Skipped, and said
    so, when the card is in an exclusive compute mode."""
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import zmq

    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.io.streamio import load_capture
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
    from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

    t_phase = time.perf_counter()
    mode = compute_mode()
    base = dict(phase="mesh_server", part="shared_card", card=smi, compute_mode=mode)
    if "exclusive" in mode.lower():
        emit(dict(base, ran=False,
                  why="the card is in an exclusive compute mode: ranks cannot share it"))
        return
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_shared_")
    ctx = zmq.Context()
    sub = ctx.socket(zmq.SUB)
    try:
        src, _ = save_shared_capture(tmp, dev)
        state = os.path.join(tmp, "calibration.npz")
        data = f"tcp://127.0.0.1:{free_tcp_port()}"
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        sub.setsockopt(zmq.RCVTIMEO, 200)
        sub.connect(data)
        cmd = [sys.executable, "-m", "coherent_rtlsdr_tpu_torch.apps.coherent_server",
               "--fft-impl", "fused", "-n", str(N_CH), "-b", str(L), "--source", "file",
               "--capture", src, "--scan-depth", "32", "--state", state,
               "--mesh", str(MESH_SHARED_RANKS), "-A", data,
               "--ctrl-address", f"tcp://127.0.0.1:{free_tcp_port()}",
               "--debug-address", f"tcp://127.0.0.1:{free_tcp_port()}"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        frames = []
        try:
            while proc.poll() is None and time.perf_counter() - t0 < PAR_RANK_TIMEOUT_S:
                try:
                    frames.append(sub.recv())
                except zmq.Again:
                    pass
            while True:   # what is still queued after the app left
                try:
                    frames.append(sub.recv())
                except zmq.Again:
                    break
            stdout = proc.communicate(timeout=30)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"coherent_server --mesh {MESH_SHARED_RANKS}: exit "
                                 f"{proc.returncode}\n{stdout[-4000:]}")
        followers = [line for line in stdout.splitlines() if line.startswith("rank ")]
        if not (f"published {PAR_T_SHARED} frames" in stdout
                and len(followers) == MESH_SHARED_RANKS - 1 and len(frames) >= 16):
            raise AssertionError(f"coherent_server --mesh {MESH_SHARED_RANKS}: {len(frames)} "
                                 f"frames received; stdout {stdout[-3000:]}")
        bars = check_frames(frames[-16:], N_CH, "mesh app frames")
        saved = np.load(state)
        # The unsharded server on the same capture.
        cfg = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                             lag_method="phase_zoom")
        one = CoherentServer(cfg, FileSource(load_capture(src)), publisher=RecordingPublisher(),
                             control=QueueControl(), scan_depth=32, device=dev)
        one.run()
        delay_err = float(np.abs(saved["delay"] - one.state.delay).max())
        synced = int(saved["synced"].sum())
        if not (synced == N_CH and delay_err <= MESH_SHARED_DELAY_ATOL):
            raise AssertionError(f"mesh app checkpoint: {synced} / {N_CH} synced, delays "
                                 f"{delay_err} off the unsharded server's")
        banner = next(line for line in stdout.splitlines() if "channel shards" in line)
        emit(dict(base, ran=True, ranks=MESH_SHARED_RANKS, N=N_CH, L=L, T=PAR_T_SHARED,
                  scan_depth=32, wall_s=wall, banner=banner, followers=followers,
                  frames_received=len(frames), frames=bars,
                  checkpoint=dict(synced=f"{synced} / {N_CH}",
                                  max_abs_delay_vs_unsharded=delay_err),
                  seconds=time.perf_counter() - t_phase))
    finally:
        sub.close(0)
        ctx.term()
        shutil.rmtree(tmp, ignore_errors=True)


def main_phase_22(dev):
    """Phase 22 alone: the kernels built, phase 16's capture rendered and
    its first frames from the packed runner, then (a) and (b)."""
    from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
    from coherent_rtlsdr_tpu_torch.kernels.fourstep import get_fourstep_kernel
    from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig
    from coherent_rtlsdr_tpu_torch.tools.probe_roofline import smi_line

    smi = smi_line()
    report = fused_cuda.build()
    emit(dict(phase="device_and_build", card=smi, torch=torch.__version__,
              cuda=torch.version.cuda, nvcc_build_s=report["seconds"]))
    k = get_fused_kernels(2 * L, dev)
    fk = get_fourstep_kernel(2 * L, dev)
    cfg = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                         lag_method="phase_zoom")
    cap, _ = render_capture(2 * SERVER_WARM + (SERVER_WINDOWS + 1) * SERVER_WINDOW[32] + 8, dev)
    want = runner_frames(cfg, cap, SERVER_WARM, dev)
    phase_mesh_server(dev, smi, k, fk, cap, want)
    phase_mesh_server_shared_card(dev, smi)
    return 0


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-rank":
        return parallel_rank(*sys.argv[2:5])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--phase", "22"]:
        return main_phase_22(torch.device("cuda", 0))
    from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
    from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels
    from coherent_rtlsdr_tpu_torch.pipeline import (
        PipelineConfig,
        init_state,
        make_packed_scan_runner,
        step,
    )
    from coherent_rtlsdr_tpu_torch.pipeline.state import (
        TELEMETRY_COLS,
        pack_state,
        unpack_state,
    )
    from coherent_rtlsdr_tpu_torch.tools import cost_model
    from coherent_rtlsdr_tpu_torch.tools.probe_roofline import smi_line

    dev = torch.device("cuda", 0)
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)

    # 1. Device and build.
    report = fused_cuda.build()
    emit(dict(phase="device_and_build", card=smi, torch=torch.__version__,
              cuda=torch.version.cuda, nvcc_build_s=report["seconds"]))

    # 2. Kernel against plain version.
    emit(dict(phase="kernel_vs_plain", card=smi, results=phase_kernels(dev)))

    cfg = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="fused",
                         lag_method="phase_zoom")
    k = get_fused_kernels(2 * L, dev)

    col = {name: i for i, name in enumerate(TELEMETRY_COLS)}

    # 3. Offline engine at full width.
    raw, ref_raw, cap = synth_raw(T_OFFLINE, L, N_CH, seed=3, dev=dev)
    sig_u8 = cap.sig_u8.reshape(T_OFFLINE, N_CH, 2 * L)
    ref_u8 = cap.ref_u8.reshape(T_OFFLINE, 2 * L)
    offline_run(cfg, sig_u8, ref_u8)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = None

    def drive_offline():
        nonlocal res
        res = offline_run(cfg, sig_u8, ref_u8)

    k.reset_counts()
    ms_runs = [cuda_ms(drive_offline) for _ in range(7)]
    counts_offline = k.counts()
    launched_only_kernels(counts_offline, 7, "offline engine")
    ms_offline = statistics.median(ms_runs)
    samples = (T_OFFLINE - 1) * N_CH * L
    delays = res.delay[0].cpu().numpy()
    lag_truth_err = float(abs(delays - cap.truth.delays).max())
    if not (tuple(res.wire.shape) == (T_OFFLINE - 1, N_CH, 2 * L)
            and torch.isfinite(res.lag).all() and lag_truth_err < 0.05
            and res.mag.min().item() > 0.5):
        raise AssertionError(f"offline output wrong: max |delay - truth| {lag_truth_err}, "
                             f"min mag {res.mag.min().item()}")
    emit(dict(phase="offline", card=smi, N=N_CH, L=L, T=T_OFFLINE, smoothing="global",
              ms_median=ms_offline, ms_runs=ms_runs, samples_per_s=samples / ms_offline * 1e3,
              realtime_x=samples / ms_offline * 1e3 / (N_CH * 2.048e6),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              max_abs_delay_minus_truth=lag_truth_err, launches=counts_offline))

    # 4. Quality against synthetic truth (bench.py:bench_quality recipe).
    q_raw, q_ref, q_cap = synth_raw(16, L, N_CH, seed=7, dev=dev)
    q = offline_run(cfg, q_cap.sig_u8.reshape(16, N_CH, 2 * L), q_cap.ref_u8.reshape(16, 2 * L))
    z = (q.aligned * q.ref.conj()[:, None, :]).sum(-1)
    errs_deg = torch.rad2deg(torch.angle(z))[2:].double()
    phase_rms = errs_deg.pow(2).mean().sqrt().item()
    lag_err = q.delay[2:].double().cpu() - torch.from_numpy(q_cap.truth.delays).double()[None]
    lag_rms = lag_err.pow(2).mean().sqrt().item()
    emit(dict(phase="quality", card=smi, N=N_CH, L=L, T=16, phase_err_deg_rms=phase_rms,
              residual_lag_rms_samples=lag_rms, bars=[PHASE_ERR_DEG, LAG_ERR_SAMPLES]))
    if not (phase_rms <= PHASE_ERR_DEG and lag_rms <= LAG_ERR_SAMPLES):
        raise AssertionError(f"quality: {phase_rms} deg, {lag_rms} samples")

    # 5. Streaming: the packed scan runner on a continuous synthetic stream.
    n_stream = K_STREAM * CALLS_STREAM
    n_synth = n_stream + K_STREAM   # one more call's blocks for phase 7
    _, _, s_cap = synth_raw(n_synth, L, N_CH, seed=5, dev=dev)
    sigs = s_cap.sig_u8.reshape(n_synth, N_CH, 2 * L)
    refs = s_cap.ref_u8.reshape(n_synth, 2 * L)
    seqs = torch.arange(1, n_synth + 1, device=dev)[:, None].expand(n_synth, N_CH)
    run = make_packed_scan_runner(cfg)
    pstate = pack_state(init_state(cfg, dev))
    call_s = []
    k.reset_counts()
    for c in range(CALLS_STREAM):
        blk = slice(c * K_STREAM, (c + 1) * K_STREAM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pstate, (wire, wire_ref), telem = run(pstate, sigs[blk], refs[blk], True, seqs[blk])
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    counts_stream = k.counts()
    launched_only_kernels(counts_stream, n_stream, "streaming")
    # Each kernel against its plain version on the inputs the next streaming
    # step gives it: the history and current block, the control law's
    # advance and the phase EMA's factor.
    seen = kernel_inputs(k, lambda: step(cfg, unpack_state(*pstate), sigs[n_stream],
                                         refs[n_stream], True, seq=seqs[n_stream]))
    errs_step, _ = hold_measure(k, seen["measure_spec"][0], seen["measure_ref"][0],
                                "streaming step")
    errs_step.update(hold_apply(k, seen["apply_spec_i8"], "streaming step"))
    errs_step.update(measure_shape=list(seen["measure_spec"][0].shape),
                     apply_shape=list(seen["apply_spec_i8"][0].shape))
    synced = telem[-1, :, col["synced"]]
    delay_final = pstate[0][:, 0].cpu().numpy()
    res_truth = delay_final - s_cap.truth.delays
    resid_tel = telem[-1, :, col["residual"]]
    steady = sum(call_s[1:])
    emit(dict(phase="streaming", card=smi, N=N_CH, L=L, K=K_STREAM, calls=CALLS_STREAM,
              call_s=call_s,
              samples_per_s_after_first_call=(CALLS_STREAM - 1) * K_STREAM * N_CH * L / steady,
              synced=int(synced.sum().item()),
              residual_lag_rms_vs_truth=float((res_truth ** 2).mean() ** 0.5),
              telemetry_residual_rms=resid_tel.pow(2).mean().sqrt().item(),
              launches=counts_stream, kernel_vs_plain=errs_step))
    if not (synced.all() and tuple(wire.shape) == (K_STREAM, N_CH, 2 * L)
            and torch.isfinite(telem).all()):
        raise AssertionError("streaming: not every channel synced or bad output")

    # 6. Kernels against plain versions at the offline shapes, timed.
    errs6, want = hold_measure(k, raw, ref_raw, "offline shapes")
    adv = res.delay.contiguous()
    pre, pim = res.phase.real.contiguous(), res.phase.imag.contiguous()
    errs6.update(hold_apply(k, (want[5], want[6], adv, pre, pim), "offline shapes"))
    del want
    R, eref = k.measure_ref(ref_raw)
    meas = k.measure_spec(raw, R, eref)
    fns = {
        "measure_ref": lambda: k.measure_ref(ref_raw),
        "measure_ref_plain": lambda: k.measure_ref_plain(ref_raw),
        "measure": lambda: k.measure_spec(raw, R, eref),
        "measure_plain": lambda: k.measure_spec_plain(raw, R, eref),
        "apply": lambda: k.apply_spec_i8(meas[5], meas[6], adv, pre, pim),
        "apply_plain": lambda: k.apply_spec_i8_plain(meas[5], meas[6], adv, pre, pim),
    }
    times = {name: [] for name in fns}
    for name in fns:
        cuda_ms(fns[name])   # warm-up
    for order in (("plain", ""), ("", "plain"), ("", "plain"), ("plain", "")):
        for base in ("measure_ref", "measure", "apply"):
            for suffix in order:
                name = base + ("_" + suffix if suffix else "")
                times[name].append(cuda_ms(fns[name]))
    ms = {name: statistics.median(v) for name, v in times.items()}
    emit(dict(phase="kernel_times", card=smi, N=N_CH, L=L, T=T_OFFLINE, ms=ms, runs=times,
              kernel_vs_plain=errs6))

    # 7. Where the time goes: one more streaming call and one offline run
    # under torch.profiler.
    blk = slice(n_stream, n_synth)
    prof_offline = device_profile(lambda: offline_run(cfg, sig_u8, ref_u8))
    emit(dict(phase="profile", card=smi,
              streaming_call=device_profile(
                  lambda: run(pstate, sigs[blk], refs[blk], True, seqs[blk])),
              offline=prof_offline))

    # --- The generic path and FusedSpectral. ---------------------------
    from coherent_rtlsdr_tpu_torch.kernels.backend import FusedSpectral
    from coherent_rtlsdr_tpu_torch.kernels.fourstep import get_fourstep_kernel
    from coherent_rtlsdr_tpu_torch.ops.convert import u8_to_c64

    # 8. Generic kernels against plain versions.
    emit(dict(phase="generic_kernel_vs_plain", card=smi, results=phase_generic_kernels(dev)))

    gcfg = PipelineConfig(n_channels=N_CH, block_len=L, **GENERIC)
    fk = get_fourstep_kernel(2 * L, dev)

    # 9. Generic offline engine at full width, fft_impl="pallas".
    offline_run(gcfg, sig_u8, ref_u8)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gres = None

    def drive_generic():
        nonlocal gres
        gres = offline_run(gcfg, sig_u8, ref_u8)

    n_runs = 7
    fk.reset_counts()
    k.reset_counts()
    g_runs = [cuda_ms(drive_generic) for _ in range(n_runs)]
    counts_goff = fk.counts()
    launched_only(counts_goff, dict(fft_launches=2 * n_runs, ifft_launches=2 * n_runs),
                  "generic offline")
    launched_only(k.counts(), {}, "generic offline (fused kernels)")
    peak_g = torch.cuda.max_memory_allocated() / 1e9
    ms_g = statistics.median(g_runs)
    g_err = float(abs(gres.delay[0].cpu().numpy() - cap.truth.delays).max())
    if not (tuple(gres.aligned.shape) == (T_OFFLINE - 1, N_CH, L)
            and torch.isfinite(gres.lag).all() and g_err < GEN_LAG_MAX
            and gres.mag.min().item() > 0.5):
        raise AssertionError(f"generic offline output wrong: max |delay - truth| {g_err}, "
                             f"min mag {gres.mag.min().item()}")
    del gres
    xcfg = PipelineConfig(n_channels=N_CH, block_len=L, fft_impl="xla", lag_method="phase_slope")
    offline_run(xcfg, sig_u8, ref_u8)   # warm-up
    x_runs = [cuda_ms(lambda: offline_run(xcfg, sig_u8, ref_u8)) for _ in range(3)]
    ms_x = statistics.median(x_runs)
    emit(dict(phase="generic_offline", card=smi, N=N_CH, L=L, T=T_OFFLINE, **GENERIC,
              smoothing="global", ms_median=ms_g, ms_runs=g_runs,
              samples_per_s=samples / ms_g * 1e3, peak_mem_gb=peak_g,
              max_abs_delay_minus_truth=g_err, launches=counts_goff,
              xla_cufft=dict(ms_median=ms_x, ms_runs=x_runs, samples_per_s=samples / ms_x * 1e3),
              profile=device_profile(lambda: offline_run(gcfg, sig_u8, ref_u8))))

    # 10. Generic quality against synthetic truth (the phase 4 capture).
    gq = offline_run(gcfg, q_cap.sig_u8.reshape(16, N_CH, 2 * L),
                     q_cap.ref_u8.reshape(16, 2 * L))
    z = (gq.aligned * gq.ref.conj()[:, None, :]).sum(-1)
    g_deg = torch.rad2deg(torch.angle(z))[2:].double()
    g_lag = gq.delay[2:].double().cpu() - torch.from_numpy(q_cap.truth.delays).double()[None]
    gq_out = dict(phase_err_deg_rms=g_deg.pow(2).mean().sqrt().item(),
                  residual_lag_rms_samples=g_lag.pow(2).mean().sqrt().item(),
                  phase_err_deg_max=g_deg.abs().max().item(),
                  lag_err_max_samples=g_lag.abs().max().item())
    emit(dict(phase="generic_quality", card=smi, N=N_CH, L=L, T=16, **GENERIC, **gq_out,
              bars=[GEN_PHASE_MAX_DEG, GEN_LAG_MAX]))
    if not (gq_out["phase_err_deg_max"] <= GEN_PHASE_MAX_DEG
            and gq_out["lag_err_max_samples"] <= GEN_LAG_MAX):
        raise AssertionError(f"generic quality: {gq_out}")

    # 11. Generic streaming: the packed scan runner on the phase 5 stream.
    grun = make_packed_scan_runner(gcfg)
    gp = pack_state(init_state(gcfg, dev))
    g_call_s = []
    fk.reset_counts()
    k.reset_counts()
    for c in range(CALLS_STREAM):
        blk = slice(c * K_STREAM, (c + 1) * K_STREAM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp, (gw, gwr), gtel = grun(gp, sigs[blk], refs[blk], True, seqs[blk])
        torch.cuda.synchronize()
        g_call_s.append(time.perf_counter() - t0)
    counts_gstream = fk.counts()
    launched_only(counts_gstream, dict(fft_launches=2 * n_stream, ifft_launches=2 * n_stream),
                  "generic streaming")
    launched_only(k.counts(), {}, "generic streaming (fused kernels)")
    g_synced = gtel[-1, :, col["synced"]]
    g_delay = gp[0][:, 0].cpu().numpy()
    blk = slice(n_stream, n_synth)
    emit(dict(phase="generic_streaming", card=smi, N=N_CH, L=L, K=K_STREAM,
              calls=CALLS_STREAM, **GENERIC, call_s=g_call_s,
              samples_per_s_after_first_call=(CALLS_STREAM - 1) * K_STREAM * N_CH * L
              / sum(g_call_s[1:]),
              synced=int(g_synced.sum().item()),
              residual_lag_rms_vs_truth=float(((g_delay - s_cap.truth.delays) ** 2).mean() ** 0.5),
              launches=counts_gstream,
              profile=device_profile(lambda: grun(gp, sigs[blk], refs[blk], True, seqs[blk]))))
    if not (g_synced.all() and tuple(gw.shape) == (K_STREAM, N_CH, L, 2)
            and tuple(gwr.shape) == (K_STREAM, L, 2) and torch.isfinite(gtel).all()):
        raise AssertionError("generic streaming: not every channel synced or bad output")

    # 12. FusedSpectral at full width: prepare -> measure -> correct.
    sig_c = u8_to_c64(sig_u8.reshape(T_OFFLINE, N_CH, L, 2))
    ref_c = u8_to_c64(ref_u8.reshape(T_OFFLINE, L, 2))
    fsp = FusedSpectral(2 * L, dev)
    fctx = fest = fy = None

    def drive_fsp():
        nonlocal fctx, fest, fy
        fy = None   # the previous call's output, freed before the next one
        fctx = fsp.prepare(sig_c, ref_c)
        fest = fsp.measure(fctx, "phase_zoom")
        fy = fsp.correct(fctx, fest.lag)

    fk.reset_counts()
    k.reset_counts()
    drive_fsp()
    torch.cuda.synchronize()
    counts_fsp = {**fk.counts(), **k.counts()}
    launched_only(fk.counts(), dict(fft_launches=1), "FusedSpectral (four-step)")
    launched_only(k.counts(), dict(measure_launches=1, apply_launches=1),
                  "FusedSpectral (float measure/apply)")
    f_err = float(abs(fest.lag.median(dim=0).values.cpu().numpy() - cap.truth.delays).max())
    fsp_runs = [cuda_ms(drive_fsp) for _ in range(3)]
    emit(dict(phase="fused_spectral", card=smi, N=N_CH, L=L, T=T_OFFLINE,
              ms_median=statistics.median(fsp_runs), ms_runs=fsp_runs,
              launches={name: n for name, n in counts_fsp.items() if n},
              max_abs_median_lag_minus_truth=f_err, mag_min=fest.mag.min().item()))
    if not (tuple(fy.shape) == (T_OFFLINE - 1, N_CH, L)
            and torch.isfinite(torch.view_as_real(fy)).all()
            and f_err < GEN_LAG_MAX and fest.mag.min().item() > 0.5):
        raise AssertionError(f"FusedSpectral output wrong: lag {f_err}, "
                             f"min mag {fest.mag.min().item()}")
    del fy

    # 13. Generic kernels against plain versions (and torch.fft) at the
    # offline shapes, timed: the four-step over the B = 5,355 channel
    # windows, the float measure/apply at T = 256.
    w_sig = torch.cat([sig_c[:-1], sig_c[1:]], dim=-1).reshape(-1, 2 * L)
    B = w_sig.shape[0]
    errs13 = hold_fourstep(fk, w_sig, "offline shapes")
    errs13.update(hold_float_measure(k, fctx, "offline shapes"))
    errs13.update(hold_float_apply(k, fctx, fest.lag, "offline shapes"))
    Xw = fk.fft(w_sig)
    adv = fest.lag.contiguous()
    fns = {
        "fft": lambda: fk.fft(w_sig), "fft_plain": lambda: fk.fft_plain(w_sig),
        "fft_lib": lambda: torch.fft.fft(w_sig),
        "ifft": lambda: fk.ifft(Xw), "ifft_plain": lambda: fk.ifft_plain(Xw),
        "ifft_lib": lambda: torch.fft.ifft(w_sig),
        "measure": lambda: k.measure(*fctx), "measure_plain": lambda: k.measure_plain(*fctx),
        "apply": lambda: k.apply(fctx.pre, fctx.pim, adv),
        "apply_plain": lambda: k.apply_plain(fctx.pre, fctx.pim, adv),
    }
    ms13, runs13 = timed_interleaved({n: f for n, f in fns.items() if n.startswith(("fft", "ifft"))},
                                     ("fft", "ifft"), ("_plain", "", "_lib"), reps=FFT_REPS)
    ms13b, runs13b = timed_interleaved(
        {n: f for n, f in fns.items() if not n.startswith(("fft", "ifft"))},
        ("measure", "apply"), ("_plain", ""))
    ms13.update(ms13b)
    runs13.update(runs13b)
    # Device time of each float kernel: one measure and one apply under the
    # profiler.
    prof13 = device_profile(lambda: (fns["measure"](), fns["apply"]()))
    emit(dict(phase="generic_kernel_times", card=smi, N=N_CH, L=L, T=T_OFFLINE, B=B, ms=ms13,
              runs=runs13, fft_reps=FFT_REPS, fused_kernel_ms=prof13["fused_kernel_ms"],
              kernel_vs_plain=errs13,
              kernel_over_torch_fft=dict(fft=ms13["fft"] / ms13["fft_lib"],
                                         ifft=ms13["ifft"] / ms13["ifft_lib"])))

    # --- The recompute pair and the roofline probe. --------------------
    from coherent_rtlsdr_tpu_torch.kernels.copy import get_block_copy
    from coherent_rtlsdr_tpu_torch.ops.phase import unit_phasor
    from coherent_rtlsdr_tpu_torch.tools import probe_roofline

    # 14. The recompute kernels against their plain versions, then the pair
    # driven at the offline shapes on the phase 3 bytes.
    emit(dict(phase="recompute_kernel_vs_plain", card=smi, results=phase_recompute_kernels(dev)))
    k.reset_counts()
    rec = k.measure_i8(raw, ref_raw)
    pc = unit_phasor(torch.complex(rec[1], -rec[2]))
    p_re, p_im = pc.real.contiguous(), pc.imag.contiguous()
    wire_r = k.apply_i8(raw, rec[0], p_re, p_im)
    torch.cuda.synchronize()
    counts_rec = k.counts()
    launched_only(counts_rec, dict(measure_ref_launches=1, measure_i8_launches=1,
                                   apply_i8_launches=1), "recompute pair")
    rec_deg = wire_phase_deg(wire_r, ref_raw)
    if not (wire_r.shape == (T_OFFLINE - 1, *raw.shape[1:])
            and all(torch.isfinite(x).all() for x in rec) and rec[3].min().item() > 0.5
            and rec_deg.abs().max().item() <= RECOMPUTE_PHASE_MAX_DEG):
        raise AssertionError(f"recompute pair output wrong: min mag {rec[3].min().item()}, "
                             f"max |phase| {rec_deg.abs().max().item()} deg")
    spec = k.measure_i8_spec(raw, ref_raw)
    contract = hold_handoff_contract(rec, wire_r, spec[:5],
                                     k.apply_spec_i8(spec[5], spec[6], rec[0], p_re, p_im))
    del spec
    errs14 = hold_recompute(k, raw, ref_raw, (rec[0], p_re, p_im), "offline shapes")
    R, eref = k.measure_ref(ref_raw)
    ms14, runs14 = timed_interleaved({
        "measure_i8": lambda: fused_cuda.measure_i8(k, raw, R, eref),
        "measure_i8_plain": lambda: k.measure_i8_plain(raw, R, eref),
        "apply_i8": lambda: k.apply_i8(raw, rec[0], p_re, p_im),
        "apply_i8_plain": lambda: k.apply_i8_plain(raw, rec[0], p_re, p_im),
    }, ("measure_i8", "apply_i8"), ("_plain", ""))
    emit(dict(phase="recompute_pair", card=smi, N=N_CH, L=L, T=T_OFFLINE,
              launches=counts_rec, mag_min=rec[3].min().item(),
              wire_phase_deg_max=rec_deg.abs().max().item(),
              wire_phase_deg_rms=rec_deg.pow(2).mean().sqrt().item(),
              handoff_contract=contract, kernel_vs_plain=errs14, ms=ms14, runs=runs14))
    del R, eref, wire_r

    # 15. The roofline probe at full size, then the block copy held
    # bit-equal and timed.
    copier = get_block_copy()
    copier.reset_counts()
    k.reset_counts()
    probe = probe_roofline.run(dev)
    counts_probe = {**copier.counts(), **k.counts()}
    probed = [v for key in ("copy_GBps", "torch_copy_GBps", "xor_GBps")
              for v in probe[key].values()]
    probed += [probe["copy_nc7_GBps"], probe["matmul_TFLOPs"]]
    probed += [f[p]["ms"] for f in probe["fused"] for p in ("handoff", "recompute")]
    if not (counts_probe == dict.fromkeys(counts_probe, 0) | probe["launches"]
            and not any(name.endswith("_plain_runs") for name in probe["launches"])
            and all(probe["launches"].get(f"{name}_launches", 0) > 0
                    for name in ("copy", "measure_ref", "measure_spec", "apply_spec_i8",
                                 "measure_i8", "apply_i8"))
            and all(v > 0 and v == v for v in probed)):
        raise AssertionError(f"roofline probe: launches {counts_probe}, probe {probe}")
    copy_equal = {}
    for nc in (1, 7):
        y = copier.copy(raw, nc)
        copy_equal[f"nc{nc}"] = torch.equal(y, raw) and torch.equal(y, copier.copy_plain(raw))
    torch.cuda.synchronize()
    if not all(copy_equal.values()):
        raise AssertionError(f"copy_blocks is not bit-equal to its input: {copy_equal}")
    ms15, runs15 = timed_interleaved({
        "copy": lambda: copier.copy(raw, 1), "copy_plain": lambda: copier.copy_plain(raw),
        "copy_lib": raw.clone}, ("copy",), ("_plain", "", "_lib"), reps=COPY_REPS)
    emit(dict(phase="roofline_probe", card=smi, probe=probe, launches=counts_probe,
              copy_bit_equal=copy_equal, copy_shape=list(raw.shape), ms=ms15, runs=runs15,
              copy_reps=COPY_REPS, copy_over_clone=ms15["copy"] / ms15["copy_lib"]))

    # 16. The streaming server (io/server.py): fused at scan depth 1 and 32,
    # console and hot-plug, checkpoint, the generic path, Farrow.
    rec16, counts_server, counts_gserver, cap16, want16 = phase_server(dev, smi, k, fk)
    emit(rec16)

    # 17. The native ring server: the port's native host edge (C++ ring,
    # file / ZMQ / librtlsdr producers, native publisher) feeding the fused
    # server.
    counts_ring = phase_ring_server(dev, smi, k, cap16, want16)

    # 18. The array models at the production array, and the MUSIC client
    # app on the card fed by the fused server over ZMQ.
    rec18 = phase_models(dev)
    rec18_client, counts_music = phase_music_client(dev, k, cap16)
    emit(dict(phase="models", card=smi, models=rec18, music_client=rec18_client))

    # 19. The fused main path at L = 32768 (m = 256): the four cluster
    # kernels, the offline engine, quality and the server.
    p19, cap19 = phase_l32768(dev, smi)

    # 20. The generic path, FusedSpectral and the recompute pair at
    # L = 32768: rows 4-7 on their cluster kernels, and the generic server.
    p20 = phase_generic_l32768(dev, smi, cap19)
    del cap19

    # 21. parallel/: the sharded runners in a one-rank NCCL group, then
    # ranks that share the card over gloo, as child processes.
    phase_parallel_one_rank(dev, smi)
    phase_parallel_shared_card(dev, smi)

    # 22. The streaming server on a channel mesh: a one-rank NCCL group on
    # phase 16's capture beside the unsharded server, then the app's three
    # gloo ranks sharing the card.
    counts_mesh, four_mesh = phase_mesh_server(dev, smi, k, fk, cap16, want16)
    del cap16, want16
    phase_mesh_server_shared_card(dev, smi)

    # The kernels line. launches: the main path's runs (phases 3, 5, 14, 15,
    # 16, 17, 18 and 22 for the i8 kernels; 9, 11, 12, 16 and 22 for the four-step; 12 for the
    # float kernels; 15 for the copy). max_abs_err: the largest
    # kernel-vs-plain difference seen (R for the reference kernel, lag in
    # samples for the i8 measure kernels, wire LSB for the i8 applies,
    # |diff| of the spectrum for the four-step and of the samples for the
    # float apply, bytes for the copy). ms, plain_ms, library_ms: medians at
    # the offline shapes (phases 6, 13, 14 and 15). device_ms: the kernel's
    # time under torch.profiler (phase 7 for the handoff apply, 13 for the
    # float pair). bound_ms, bound_by: tools/cost_model.py at those shapes.
    # The eight "@256" entries: phase 19 for the fused path's four (launches
    # from (b), its recompute measure and (e); errors from (a) and (d); ms,
    # plain_ms and device_ms from (d) at T = 64, N = 21, L = 32768), phase 20
    # for rows 4-7 (launches from (b), (c), (d) and (f); errors from (a) and
    # the offline shapes; ms, plain_ms, library_ms and device_ms from (e),
    # the four-step at B = 1,323).
    launches = {c: counts_offline[c] + counts_stream[c] + counts_rec[c] + counts_probe[c]
                + counts_server[c] + counts_ring[c] + counts_music[c] + counts_mesh[c]
                for c in counts_offline}
    worst = lambda key: max(errs_step[key], errs6[key])
    m = round((2 * L) ** 0.5)
    shape = (T_OFFLINE, N_CH, m)
    src = "coherent_rtlsdr_tpu_torch/csrc/"
    tpu = "coherent_rtlsdr_tpu/kernels/"

    def entry(name, source, replaces, cost, n_launch, err, ms_k, ms_p, lib=None, **extra):
        b_ms, b_by = cost_model.bound(cost)
        return dict(name=name, route="cuda", source=src + source, replaces=replaces,
                    launches=n_launch, max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib, **extra)

    fourstep_launches = (counts_goff["fft_launches"] + counts_goff["ifft_launches"]
                         + counts_gstream["fft_launches"] + counts_gstream["ifft_launches"]
                         + counts_fsp["fft_launches"] + counts_gserver["fft_launches"]
                         + counts_gserver["ifft_launches"] + four_mesh["fft_launches"]
                         + four_mesh["ifft_launches"])
    # Registers, stack and spills of every kernel; the twenty-seven
    # tensor-core instantiations (measure, apply, four-step) must use no
    # stack and spill nothing.
    ptxas = {src: fused_cuda.ptxas_usage(report[src]) for src in fused_cuda.SOURCES}
    emit(dict(phase="ptxas", **ptxas))
    tc_ptxas = {name: ptxas[src].get(name)
                for src, names in fused_cuda.TC_KERNELS.items() for name in names}
    spilled = [name for name, u in tc_ptxas.items()
               if u is None or u["stack"] or u["spill_stores"] or u["spill_loads"]]
    if spilled:
        raise AssertionError(f"tensor-core kernels with stack or spills (or no report): "
                             f"{spilled}")
    print(smi, flush=True)
    emit({"kernels": [
        entry("fused_measure_ref", "fused_measure.cu", tpu + "pallas_fused.py:356",
              cost_model.measure_ref(T_OFFLINE, m), launches["measure_ref_launches"],
              worst("R_max_abs_err"), ms["measure_ref"], ms["measure_ref_plain"]),
        entry("fused_measure_i8_spec", "fused_measure.cu", tpu + "pallas_fused.py:338",
              cost_model.measure_i8_spec(*shape), launches["measure_spec_launches"],
              worst("lag_max_abs_err"), ms["measure"], ms["measure_plain"]),
        entry("fused_apply_spec_i8", "fused_apply.cu", tpu + "pallas_fused.py:392",
              cost_model.apply_spec_i8(*shape), launches["apply_spec_i8_launches"],
              worst("wire_max_lsb"), ms["apply"], ms["apply_plain"],
              device_ms=prof_offline["fused_kernel_ms"].get(f"fused::apply_spec_kernel<{m}>")),
        entry("fused_measure_i8", "fused_measure.cu", tpu + "pallas_fused.py:279",
              cost_model.measure_i8(*shape), launches["measure_i8_launches"],
              errs14["lag_max_abs_err"], ms14["measure_i8"], ms14["measure_i8_plain"]),
        entry("fused_apply_i8", "fused_apply.cu", tpu + "pallas_fused.py:447",
              cost_model.apply_i8(*shape), launches["apply_i8_launches"],
              errs14["wire_max_lsb"], ms14["apply_i8"], ms14["apply_i8_plain"]),
        entry("fourstep_fft", "fourstep.cu", tpu + "pallas_fft.py:32", cost_model.fourstep(B, m),
              fourstep_launches, max(errs13["fwd_max_abs_err"], errs13["inv_max_abs_err"]),
              ms13["fft"], ms13["fft_plain"], ms13["fft_lib"], ms_inverse=ms13["ifft"],
              plain_ms_inverse=ms13["ifft_plain"], library_ms_inverse=ms13["ifft_lib"]),
        entry("fused_measure_planes", "fused_measure.cu", tpu + "pallas_fused.py:185",
              cost_model.measure_planes(*shape), counts_fsp["measure_launches"],
              errs13["lag_max_abs_err"], ms13["measure"], ms13["measure_plain"],
              device_ms=prof13["fused_kernel_ms"].get(f"fused::measure_planes_kernel<{m}>")),
        entry("fused_apply_planes", "fused_apply.cu", tpu + "pallas_fused.py:220",
              cost_model.apply_planes(*shape), counts_fsp["apply_launches"],
              errs13["y_max_abs_err"], ms13["apply"], ms13["apply_plain"],
              device_ms=prof13["fused_kernel_ms"].get(f"fused::apply_planes_kernel<{m}>")),
        entry("copy_blocks", "probe_copy.cu", "tools/probe_roofline.py:68",
              cost_model.copy_blocks(*shape), counts_probe["copy_launches"], 0,
              ms15["copy"], ms15["copy_plain"], ms15["copy_lib"]),
        *[entry(f"{name}@256", source, tpu + f"pallas_fused.py:{line}", cost,
                p19["launches"][f"{count}_launches"], p19["err"][base], p19["ms"][base],
                p19["ms"][base + "_plain"], device_ms=p19["device_ms"][base])
          for name, source, line, cost, count, base in (
              ("fused_measure_ref", "fused_measure.cu", 356,
               cost_model.measure_ref(T19, M19), "measure_ref", "measure_ref"),
              ("fused_measure_i8_spec", "fused_measure.cu", 338,
               cost_model.measure_i8_spec(T19, N_CH, M19), "measure_spec", "measure"),
              ("fused_measure_i8", "fused_measure.cu", 279,
               cost_model.measure_i8(T19, N_CH, M19), "measure_i8", "measure_i8"),
              ("fused_apply_spec_i8", "fused_apply.cu", 392,
               cost_model.apply_spec_i8(T19, N_CH, M19), "apply_spec_i8", "apply"))],
        *[entry(f"{name}@256", source, tpu + replaces, cost, p20["launches"][base],
                p20["err"][base], p20["ms"][base], p20["ms"][base + "_plain"],
                device_ms=p20["device_ms"][base], **extra)
          for name, source, replaces, cost, base, extra in (
              ("fused_apply_i8", "fused_apply.cu", "pallas_fused.py:447",
               cost_model.apply_i8(T19, N_CH, M19), "apply_i8", {}),
              ("fourstep_fft", "fourstep.cu", "pallas_fft.py:32",
               cost_model.fourstep(p20["B"], M19), "fft",
               dict(lib=p20["ms"]["fft_lib"], ms_inverse=p20["ms"]["ifft"],
                    plain_ms_inverse=p20["ms"]["ifft_plain"],
                    library_ms_inverse=p20["ms"]["ifft_lib"],
                    device_ms_inverse=p20["device_ms"]["ifft"])),
              ("fused_measure_planes", "fused_measure.cu", "pallas_fused.py:185",
               cost_model.measure_planes(T19, N_CH, M19), "measure", {}),
              ("fused_apply_planes", "fused_apply.cu", "pallas_fused.py:220",
               cost_model.apply_planes(T19, N_CH, M19), "apply", {}))],
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
