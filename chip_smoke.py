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
     and the first frames bit-equal to ``make_packed_scan_runner``'s on the
     same bytes; console commands mid-run (status, phase, request rd / re,
     fcenter, an fs change that forces a resync) and padded hot-plug
     (max_channels = 24, add then del, no runner rebuilt) on a synthetic
     stream rendered on the card; a checkpoint restored into a new server
     that resumes synced with its ref seqnums continuing; the generic
     server (``pallas``, 64 blocks at scan depth 8, 2 + 2 four-step
     launches a block); Farrow on the card against the CPU.

Every phase prints one JSON line; a failed check raises, so the exit code is
not 0. Before the last line it prints the ptxas report of every kernel
(registers, stack, spills; the fourteen tensor-core instantiations of the
measure and apply kernels, eight measure and six apply, must use no stack
and spill nothing), the card's name and power limit
and a JSON summary of the nine kernels (times, launches, errors, and the
bound from ``tools/cost_model.py``: the larger of bytes over 3.35 TB/s and
bf16 operations over 989 TFLOP/s); the last line is ``{"ok": true,
"device": {...}}``. Needs a CUDA device and the repository's package next
to this file.
"""

import json
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
    time, the five largest by name, and each of the port's fused kernels
    (``fused::name<m, ...>``)."""
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
             if "fused::" in name}
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


def small_blocks(m, g, dev):
    """The kernel-vs-plain inputs at m (N = 21, T = 5): random bytes drawn
    from ``g``, and the synthesizer's correlated bytes (seed m)."""
    return {
        "random": (
            torch.randint(-128, 128, (5, N_CH, m // 2, 2 * m), generator=g, device=dev,
                          dtype=torch.int8),
            torch.randint(-128, 128, (5, m // 2, 2 * m), generator=g, device=dev,
                          dtype=torch.int8)),
        "correlated": synth_raw(5, m * m // 2, N_CH, seed=m, dev=dev)[:2],
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
        self.ref_seqs = []

    def publish(self, iq_i8, seqnums, phases=None):
        from coherent_rtlsdr_tpu_torch.io.wire import pack_debug, pack_frame

        buf = pack_frame(len(self.ref_seqs), seqnums, iq_i8)
        if phases is not None:
            pack_debug(phases)
        self.ref_seqs.append(int(seqnums[0]))
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


def render_capture(n_blocks, dev, seed=11):
    """A continuous synthetic capture rendered on the card slab by slab
    (``synth_stream_slab``: max delay 40, SNR 30 dB, ppm 0) and kept in
    host memory, its seqnums counting from 1: (Capture, truth)."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.io.streamio import Capture
    from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_stream_slab

    truth = make_truth(N_CH, seed=seed, max_delay=40.0, snr_db=30.0)
    n_slabs = -(-n_blocks // SERVER_SLAB)
    T = n_slabs * SERVER_SLAB
    sig = np.empty((T, N_CH, L, 2), np.uint8)
    ref = np.empty((T, L, 2), np.uint8)
    for i in range(n_slabs):
        s, r = synth_stream_slab(seed, truth, i, SERVER_SLAB, L, device=dev)
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


def check_frames(bufs, n, where):
    """Every frame is (n + 1) x L int8 IQ, and each channel against channel
    0 peaks at lag 0 with corr >= FRAME_CORR_MIN and |phase| <
    FRAME_PHASE_MAX_DEG. Returns the worst corr and phase."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.io.wire import unpack_frame

    corr_min, phase_max = 1.0, 0.0
    for buf in bufs:
        f = unpack_frame(buf)
        if not (f.iq.shape == (n + 1, L, 2) and f.iq.dtype == np.int8):
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
    state, K = 32 a call: the frames as [T, N + 1, L, 2] int8 (ref first)."""
    import numpy as np

    from coherent_rtlsdr_tpu_torch.pipeline import init_state, make_packed_scan_runner
    from coherent_rtlsdr_tpu_torch.pipeline.state import pack_state

    run = make_packed_scan_runner(cfg)
    pstate = pack_state(init_state(cfg, dev))
    gate = torch.tensor(True, device=dev)
    out = []
    for c in range(0, n_blocks, K_STREAM):
        blk = slice(c, c + K_STREAM)
        sigs = torch.from_numpy(cap.sig_u8[blk]).to(dev).reshape(-1, N_CH, 2 * L)
        refs = torch.from_numpy(cap.ref_u8[blk]).to(dev).reshape(-1, 2 * L)
        seqs = torch.from_numpy(cap.seqnums[blk].astype(np.int64)).to(dev)
        pstate, (wire, wire_ref), _ = run(pstate, sigs, refs, gate, seqs)
        out.append(torch.cat([wire_ref.reshape(-1, 1, L, 2), wire.reshape(-1, N_CH, L, 2)],
                             dim=1).cpu().numpy())
    return np.concatenate(out)


def bit_equal(bufs, want, where):
    from coherent_rtlsdr_tpu_torch.io.wire import unpack_frame

    for t, buf in enumerate(bufs):
        if not (unpack_frame(buf).iq == want[t]).all():
            raise AssertionError(f"{where}: frame {t} differs from the packed runner's")
    return len(bufs)


def timed_server(cfg, cap, scan_depth, k, dev):
    """A server at ``scan_depth`` on the capture from its start: a warm-up
    run, then SERVER_WINDOWS timed runs. Returns (server, publisher, wall
    seconds and frames of each window, launch counts of all its runs)."""
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
        n = srv.run(max_blocks=SERVER_WINDOW[scan_depth])
        windows.append((time.perf_counter() - t0, n))
    return srv, pub, windows


def host_breakdown(srv, n_blocks):
    """One more run of ``srv`` with its loop's parts timed on the host
    clock, in ms a block. Each part is the host time of one function of
    ``io/server.py`` (or of the source), wrapped on this instance for the
    run, so a change to one of these functions changes its part:

      source          ``srv.source.next_block``
      stage           ``CoherentServer._stage`` (pad + pinned upload)
      dispatch        ``srv._step`` and ``srv._scan`` (the runner's launches)
      main_rest       the run's wall clock less the three above (queue
                      waits for the worker, control polls, the loop)
      worker_fetch    ``CoherentServer._fetch`` (its wait for the device
                      included)
      worker_publish  ``CoherentServer._publish_batch`` less its fetch
                      (frame assembly and publish)
    """
    import collections

    spent = collections.defaultdict(float)

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return run

    parts = [("source", srv.source, "next_block"), ("stage", srv, "_stage"),
             ("dispatch", srv, "_step"), ("fetch", srv, "_fetch"),
             ("publish", srv, "_publish_batch")]
    if srv._scan is not None:
        parts.append(("dispatch", srv, "_scan"))
    # (object, attribute, the instance's own value or None for a method of
    # the class, which deleting the wrapper brings back)
    saved = [(obj, attr, vars(obj).get(attr)) for _, obj, attr in parts]
    for name, obj, attr in parts:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = srv.run(max_blocks=n_blocks)
        wall = time.perf_counter() - t0
    finally:
        for obj, attr, own in saved:
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
    ms = lambda sec: sec * 1e3 / n
    main = spent["source"] + spent["stage"] + spent["dispatch"]
    return dict(blocks=n, wall_ms_per_block=ms(wall), source=ms(spent["source"]),
                stage=ms(spent["stage"]), dispatch=ms(spent["dispatch"]),
                main_rest=ms(wall - main), worker_fetch=ms(spent["fetch"]),
                worker_publish=ms(spent["publish"] - spent["fetch"]))


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
    return out, launches, four



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
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
    rec16, counts_server, counts_gserver = phase_server(dev, smi, k, fk)
    emit(rec16)

    # The kernels line. launches: the main path's runs (phases 3, 5, 14, 15
    # and 16 for the i8 kernels; 9, 11, 12 and 16 for the four-step; 12 for the
    # float kernels; 15 for the copy). max_abs_err: the largest
    # kernel-vs-plain difference seen (R for the reference kernel, lag in
    # samples for the i8 measure kernels, wire LSB for the i8 applies,
    # |diff| of the spectrum for the four-step and of the samples for the
    # float apply, bytes for the copy). ms, plain_ms, library_ms: medians at
    # the offline shapes (phases 6, 13, 14 and 15). device_ms: the kernel's
    # time under torch.profiler (phase 7 for the handoff apply, 13 for the
    # float pair). bound_ms, bound_by: tools/cost_model.py at those shapes.
    launches = {c: counts_offline[c] + counts_stream[c] + counts_rec[c] + counts_probe[c]
                + counts_server[c] for c in counts_offline}
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
                         + counts_gserver["ifft_launches"])
    # Registers, stack and spills of every kernel; the fourteen tensor-core
    # instantiations (measure and apply) must use no stack and spill nothing.
    ptxas = {src: fused_cuda.ptxas_usage(report[src]) for src in fused_cuda.SOURCES}
    emit(dict(phase="ptxas", **ptxas))
    tc_ptxas = {name: ptxas[src].get(name)
                for src, names in (("fused_measure.cu", fused_cuda.TC_MEASURE_KERNELS),
                                   ("fused_apply.cu", fused_cuda.TC_APPLY_KERNELS))
                for name in names}
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
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
