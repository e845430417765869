"""Roofline probe of the card (port of ``tools/probe_roofline.py``): how far
the fused i8 kernels are from what this GPU reaches at their shapes.

    python3 -m coherent_rtlsdr_tpu_torch.tools.probe_roofline

Measures, in one process on one GPU, at N = 21 channels, L = 8192, m = 128:

  1. the copy ceiling: ``BlockCopy`` (``csrc/probe_copy.cu``), an identity
     copy of int8 blocks [T, N, m/2, 2m], at T = 64 and 256 with one
     channel a CTA and at T = 256 with nc = 7 channels a CTA;
  2. the same bytes through PyTorch: ``x.clone()`` of the blocks and the
     XOR pass ``ops/convert.py:u8_to_i8`` on [T, N, 2L] uint8;
  3. the tensor-core ceiling: a chain of 8 bf16 4096^3 ``torch.matmul`` with
     float32 accumulation (no reduced-precision reductions, TF32 off);
  4. both i8 pairs at T = 64, 128 and 256, timed in turns: the handoff pair
     (``measure_i8_spec`` -> ``apply_spec_i8``) and the recompute pair
     (``measure_i8`` -> ``apply_i8``), with the advance and phase factor
     taken from the measurement; per pair, us a window, samples/s counting
     (T-1) N L, and the modelled GB/s and TFLOP/s of ``tools/cost_model.py``;

then the pairs' modelled rates at the largest T as fractions of the probed
copy and matmul ceilings and of the data sheet's 3.35 TB/s and 989 TFLOP/s.
Every time is the median of RUNS = 7 runs between CUDA events, after a
warm-up, each run after a write that evicts the 50 MB L2 cache. It prints
one JSON line with the card's ``nvidia-smi`` name and power limit. The functions take
``device`` (default the card, raising without one); ``device="cpu"`` runs
them on the CPU through the plain versions, where the times measure the CPU.
"""

import json
import statistics
import subprocess
import time

import torch

from coherent_rtlsdr_tpu_torch.kernels.copy import get_block_copy
from coherent_rtlsdr_tpu_torch.kernels.fused import get_fused_kernels, resolve_device
from coherent_rtlsdr_tpu_torch.ops.convert import u8_to_i8
from coherent_rtlsdr_tpu_torch.ops.phase import unit_phasor
from coherent_rtlsdr_tpu_torch.tools import cost_model

N_CH = 21
L = 8192
COPY_TS = (64, 256)
FUSED_TS = (64, 128, 256)
RUNS = 7
L2_FLUSH_BYTES = 128 << 20   # more than the H100's 50 MB L2


def smi_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the roofline probe measures the card and found none; "
                           "pass device='cpu' to run it on the CPU")
    return resolve_device(dev)


class _Timer:
    """Times one call on ``dev`` in ms: CUDA events on the card (after
    evicting L2), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
                      if dev.type == "cuda" else None)

    def __call__(self, fn) -> float:
        if self.flush is None:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        self.flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def medians(self, fns: dict) -> dict:
        """Median ms of each of ``fns`` over RUNS runs in turns, the order
        reversed every other run, after one warm-up run of each."""
        for fn in fns.values():
            fn()
        times = {name: [] for name in fns}
        order = list(fns)
        for r in range(RUNS):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(self(fns[name]))
        return {name: statistics.median(v) for name, v in times.items()}


def _blocks(T, n_ch, block_len, dev, seed=0):
    m = round((2 * block_len) ** 0.5)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-128, 128, (T, n_ch, m // 2, 2 * m), generator=g, device=dev,
                         dtype=torch.int8)


def channels_per_cta(n_ch: int) -> int:
    """The largest divisor of n_ch up to 8: the channels a grid step of the
    JAX package's fused kernels (``FusedPipelineKernels._pick_nc``), 7 at
    N = 21, the batching the nc copy probe reproduces."""
    return next(c for c in range(8, 0, -1) if n_ch % c == 0)


def probe_copy(T, nc=1, device="cuda", n_ch=N_CH, block_len=L) -> float:
    """GB/s of ``BlockCopy`` on int8 blocks [T, n_ch, m/2, 2m], ``nc``
    channels a CTA: 2 T n_ch 2L bytes a call."""
    dev = _device(device)
    x = _blocks(T, n_ch, block_len, dev)
    copier = get_block_copy()
    ms = _Timer(dev).medians({"copy": lambda: copier.copy(x, nc)})["copy"]
    return 2 * x.numel() / ms / 1e6


def probe_torch_copy(T, device="cuda", n_ch=N_CH, block_len=L) -> float:
    """GB/s of ``x.clone()`` on the same blocks."""
    dev = _device(device)
    x = _blocks(T, n_ch, block_len, dev)
    ms = _Timer(dev).medians({"clone": x.clone})["clone"]
    return 2 * x.numel() / ms / 1e6


def probe_xor(T, device="cuda", n_ch=N_CH, block_len=L) -> float:
    """GB/s of the XOR pass ``u8_to_i8`` on uint8 [T, n_ch, 2L]."""
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 256, (T, n_ch, 2 * block_len), generator=g, device=dev,
                      dtype=torch.uint8)
    ms = _Timer(dev).medians({"xor": lambda: u8_to_i8(x)})["xor"]
    return 2 * x.numel() / ms / 1e6


def probe_matmul(n=4096, reps=8, device="cuda") -> float:
    """TFLOP/s of a chain of ``reps`` bf16 n x n products (float32
    accumulation, TF32 off), 2 n^3 operations each."""
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(2)
    # Entries of variance 1/n keep the chain's values of order one.
    a = (torch.randn((n, n), generator=g, device=dev) / n ** 0.5).to(torch.bfloat16)

    def chain():
        c = a
        for _ in range(reps):
            c = torch.matmul(c, a)
        return c

    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = False, False
    try:
        ms = _Timer(dev).medians({"chain": chain})["chain"]
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = saved
    return reps * 2 * n ** 3 / ms / 1e9


def probe_fused(T, device="cuda", n_ch=N_CH, block_len=L) -> dict:
    """Both i8 pairs on random blocks [T, n_ch, m/2, 2m], timed in turns:
    per pair the median ms a call, us a window, samples/s and the modelled
    GB/s and TFLOP/s."""
    dev = _device(device)
    k = get_fused_kernels(2 * block_len, dev)
    raw = _blocks(T, n_ch, block_len, dev, seed=3)
    ref_raw = _blocks(T, 1, block_len, dev, seed=4)[:, 0]

    # The advance is the lag, the phase factor conj(z)/|z|, as in the
    # offline engine.
    def handoff():
        lag, zre, zim, _, _, dre, dim = k.measure_i8_spec(raw, ref_raw)
        pc = unit_phasor(torch.complex(zre, -zim))
        return k.apply_spec_i8(dre, dim, lag, pc.real, pc.imag)

    def recompute():
        lag, zre, zim, _, _ = k.measure_i8(raw, ref_raw)
        pc = unit_phasor(torch.complex(zre, -zim))
        return k.apply_i8(raw, lag, pc.real, pc.imag)

    ms = _Timer(dev).medians({"handoff": handoff, "recompute": recompute})
    nwin = (T - 1) * n_ch
    out = dict(T=T)
    for pair, t in ms.items():
        bps, ops = cost_model.fused_cost_model(n_ch, block_len, T, pair)
        rate = nwin * block_len / t * 1e3
        out[pair] = dict(ms=t, us_per_window=1e3 * t / nwin, samples_per_s=rate,
                         modeled_GBps=rate * bps / 1e9, modeled_TFLOPs=rate * ops / 1e12)
    out["recompute_over_handoff"] = ms["recompute"] / ms["handoff"]
    return out


def run(device="cuda", n_ch=N_CH, block_len=L, fused_ts=FUSED_TS, matmul_n=4096) -> dict:
    """Every probe; the dict that ``main`` prints. ``launches`` holds what
    the probe ran of each kernel and plain version (count deltas of the
    process's ``BlockCopy`` and ``FusedPipelineKernels``)."""
    dev = _device(device)
    copier = get_block_copy()
    k = get_fused_kernels(2 * block_len, dev)
    before = {**copier.counts(), **k.counts()}
    kw = dict(device=dev, n_ch=n_ch, block_len=block_len)
    nc = channels_per_cta(n_ch)
    out = {"device": "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev),
           "card": smi_line() if dev.type == "cuda" else None,
           "N": n_ch, "L": block_len, "runs": RUNS}
    out["copy_GBps"] = {T: probe_copy(T, 1, **kw) for T in COPY_TS}
    out[f"copy_nc{nc}_GBps"] = probe_copy(COPY_TS[-1], nc, **kw)
    out["torch_copy_GBps"] = {T: probe_torch_copy(T, **kw) for T in COPY_TS}
    out["xor_GBps"] = {T: probe_xor(T, **kw) for T in COPY_TS}
    out["matmul_TFLOPs"] = probe_matmul(matmul_n, device=dev)
    out["fused"] = [probe_fused(T, **kw) for T in fused_ts]
    last, copy = out["fused"][-1], out["copy_GBps"][COPY_TS[-1]]
    out["fractions"] = {
        pair: dict(T=last["T"],
                   of_probed_copy=last[pair]["modeled_GBps"] / copy,
                   of_probed_matmul=last[pair]["modeled_TFLOPs"] / out["matmul_TFLOPs"],
                   of_datasheet_bytes=last[pair]["modeled_GBps"] * 1e9 / cost_model.HBM_BYTES_S,
                   of_datasheet_bf16=last[pair]["modeled_TFLOPs"] * 1e12 / cost_model.BF16_FLOPS)
        for pair in ("handoff", "recompute")}
    after = {**copier.counts(), **k.counts()}
    out["launches"] = {name: after[name] - before[name] for name in after
                       if after[name] != before[name]}
    return out


def main():
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
