"""Time the m = 256 cluster kernels of two or more builds of ``csrc/`` in
turns on one card, at the main path's shapes (N = 21 channels, T = 64
blocks of L = 32768: 1,323 windows; the four-step at B = 1,323), beside
``torch.fft.fft`` / ``ifft`` on the same transforms.

Each variant is ``NAME=DIR:TABLES``: the CUDA sources in DIR (the same file
names as ``coherent_rtlsdr_tpu_torch/csrc``), built by
``fused_cuda.build`` into ``build/time_cluster/NAME``, and the table format
its m = 256 kernels take: ``pairs`` (F and Fi as float32 (re, im) pairs
[m, m, 2], the kernels before the table ring) or ``slices`` (the packed
bf16 k-slices of ``fused.cluster_slices``). To time a commit against its
parent, unpack the parent into a git-ignored directory first::

    mkdir -p build/parent && git archive HEAD~1 coherent_rtlsdr_tpu_torch/csrc \\
        | tar -x -C build/parent
    python3 -m coherent_rtlsdr_tpu_torch.tools.time_cluster \\
        --variant parent=build/parent/coherent_rtlsdr_tpu_torch/csrc:pairs \\
        --variant change=coherent_rtlsdr_tpu_torch/csrc:slices

A variant may add ``:ABLATION``, a named edit of its sources (``ABLATIONS``)
that removes one part of every m = 256 kernel so that its share of the time
shows: ``no_products`` issues no wgmma (the table ring still streams every
slice), ``no_ring`` also skips the ring's copies and waits. Their outputs
are wrong by design; the difference from the first variant is printed all
the same.

A round times every kernel of every variant once: ``reps`` back-to-back
launches between two CUDA events, the time a launch. Rounds run the
variants forward then backward (A B B A ...). Every variant gets the same
seeded inputs; each kernel's outputs are held to the first variant's (the
largest difference over the largest value, for the spectra, the four-step
and the wire bytes). Prints one JSON line a kernel, then the card's name
and power limit; needs a card.
"""

import argparse
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
from coherent_rtlsdr_tpu_torch.kernels.fused import cluster_slices, get_fused_kernels

M = 256
W = M * M
T, N = 64, 21
T1 = T - 1
B = T1 * N


_NO_PRODUCTS = [("fused_cluster.cuh", """  tc::wgmma_fence();
  tc::wgmma<N, 1>(re, ar, bre);
  tc::wgmma<N, -1>(re, ai, bim);
  tc::wgmma<N, 1>(im, ar, bim);
  tc::wgmma<N, 1>(im, ai, bre);
  tc::wgmma_commit();""", """  re[0][0] += static_cast<float>((ar[0] ^ ai[1] ^ bre ^ bim) & 1);""")]
ABLATIONS = {
    "no_products": _NO_PRODUCTS,
    "no_ring": _NO_PRODUCTS + [
        ("fused_cluster.cuh", "    mbar_wait(full(j % kStages), (j / kStages) & 1);\n", ""),
        ("fused_cluster.cuh", "    if (j + kStages < kTotal) {", "    if (false) {"),
        ("fused_cluster.cuh", "      for (int j = 0; j < first; ++j) issue(j);", "      ;"),
    ],
}


def _variant(spec: str):
    name, rest = spec.split("=", 1)
    path, tables, *ablation = rest.split(":")
    if tables not in ("pairs", "slices"):
        raise ValueError(f"{spec}: tables must be 'pairs' or 'slices'")
    if ablation and ablation[0] not in ABLATIONS:
        raise ValueError(f"{spec}: ablations are {sorted(ABLATIONS)}")
    return name, Path(path).resolve(), tables, ablation[0] if ablation else None


def _ablated(src: Path, dst: Path, ablation: str) -> Path:
    """A copy of the sources in ``src`` at ``dst`` with ``ablation``'s edits."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name, old, new in ABLATIONS[ablation]:
        text = (dst / name).read_text()
        if old not in text:
            raise ValueError(f"ablation {ablation}: {name} no longer holds {old!r}")
        (dst / name).write_text(text.replace(old, new))
    return dst


def _inputs(dev, seed: int) -> dict:
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd_i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g,
                                          dtype=torch.int8).to(dev)
    rnd_f = lambda *shape: torch.randn(*shape, generator=g).to(dev)
    x = torch.complex(rnd_f(B, M, M), rnd_f(B, M, M))
    return {
        "x": x,
        "X": torch.fft.fft(x.reshape(B, W)).reshape(B, M, M),
        "ref_raw": rnd_i8(T, M // 2, 2 * M),
        "raw": rnd_i8(T, N, M // 2, 2 * M),
        "pre": rnd_f(T, N, M // 2, M).to(torch.bfloat16),
        "pim": rnd_f(T, N, M // 2, M).to(torch.bfloat16),
        "rre": rnd_f(T1, M, M).mul(64).to(torch.bfloat16),
        "rim": rnd_f(T1, M, M).mul(64).to(torch.bfloat16),
        "advance": (rnd_f(T1, N) * 2000).contiguous(),
        "phase_re": torch.cos(rnd_f(T1, N)).contiguous(),
        "phase_im": torch.sin(rnd_f(T1, N)).contiguous(),
    }


def _calls(fns, tables, k, inp, dev):
    """{kernel: (launch, outputs to compare)} for one variant: each launch
    a C entry point on preallocated outputs."""
    F, Fi, Tw = fused_cuda._tables(k.fft)
    if tables == "slices":
        F, Fi = cluster_slices(k.fft)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: t.data_ptr()
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    R, eref = f32(T1, M, M, 2), f32(T1)
    scal = [f32(T1, N) for _ in range(5)]
    d = [torch.empty((T1, N, M, M), dtype=torch.bfloat16, device=dev) for _ in range(2)]
    wire = torch.empty((T1, N, M // 2, 2 * M), dtype=torch.int8, device=dev)
    wire2 = torch.empty_like(wire)
    yre, yim = f32(T1, N, W // 2), f32(T1, N, W // 2)
    yf, yi = torch.empty_like(inp["x"]), torch.empty_like(inp["x"])
    ph = [inp["advance"], inp["phase_re"], inp["phase_im"]]

    def fourstep(src, dst, tab, inverse):
        return lambda: fns["fourstep_fft"](ptr(src), ptr(tab), ptr(Tw), ptr(dst), B, M,
                                           int(inverse), stream)

    def measure_ref():
        return fns["fused_measure_ref"](ptr(inp["ref_raw"]), ptr(F), ptr(Tw), ptr(R),
                                        ptr(eref), T1, M, stream)

    def measure_spec():
        return fns["fused_measure_i8_spec"](ptr(inp["raw"]), ptr(F), ptr(Tw), ptr(R),
                                            ptr(eref), *map(ptr, scal + d), T1, N, M, stream)

    def measure_i8():
        return fns["fused_measure_i8"](ptr(inp["raw"]), ptr(F), ptr(Tw), ptr(R), ptr(eref),
                                       *map(ptr, scal), T1, N, M, stream)

    def apply_spec():
        return fns["fused_apply_spec_i8"](*map(ptr, d + ph), ptr(Fi), ptr(Tw), ptr(wire), T1, N,
                                          M, stream)

    def apply_i8():
        return fns["fused_apply_i8"](ptr(inp["raw"]), *map(ptr, ph), ptr(F), ptr(Fi), ptr(Tw),
                                     ptr(wire2), T1, N, M, stream)

    def measure_planes():
        return fns["fused_measure_planes"](*(ptr(inp[n]) for n in ("pre", "pim", "rre", "rim")),
                                           ptr(F), ptr(Tw), *map(ptr, scal[:4]), T1, N, M,
                                           stream)

    def apply_planes():
        return fns["fused_apply_planes"](ptr(inp["pre"]), ptr(inp["pim"]), ptr(inp["advance"]),
                                         ptr(F), ptr(Fi), ptr(Tw), ptr(yre), ptr(yim), T1, N, M,
                                         stream)

    # measure_ref first: the channel kernels read its R; measure_spec before
    # apply_spec, which reads its D.
    return {
        "fourstep_cluster_kernel<0>": (fourstep(inp["x"], yf, F, False), [yf]),
        "fourstep_cluster_kernel<1>": (fourstep(inp["X"], yi, Fi, True), [yi]),
        "measure_ref_cluster_kernel": (measure_ref, [R]),
        "measure_cluster_kernel<1>": (measure_spec, d),
        "measure_cluster_kernel<0>": (measure_i8, []),
        "apply_spec_cluster_kernel": (apply_spec, [wire]),
        "apply_i8_cluster_kernel": (apply_i8, [wire2]),
        "measure_planes_cluster_kernel": (measure_planes, []),
        "apply_planes_cluster_kernel": (apply_planes, [yre, yim]),
    }


def _time(launch, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        rc = launch()
        if rc:
            raise RuntimeError(f"CUDA error {rc} at launch")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    real = lambda t: torch.view_as_real(t) if t.is_complex() else t.float()
    a, b = real(a), real(b)
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, type=_variant,
                    help="NAME=DIR:pairs|slices[:ABLATION] (two or more, timed in turns)")
    ap.add_argument("--rounds", type=int, default=4, help="rounds (each runs every variant)")
    ap.add_argument("--reps", type=int, default=5, help="launches a timed run")
    ap.add_argument("--seed", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_cluster: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    k = get_fused_kernels(W, dev)
    inp = _inputs(dev, args.seed)
    root = Path(fused_cuda.BUILD_DIR).parent / "time_cluster"
    variants = []
    for name, path, tables, ablation in args.variant:
        if ablation:
            path = _ablated(path, root / name / "src", ablation)
        report = fused_cuda.build(path, root / name)
        usage = {}
        for src in fused_cuda.SOURCES:
            usage.update(fused_cuda.ptxas_usage(report[src]))
        variants.append((name, tables, fused_cuda._functions(path, root / name), usage))
    calls = {name: _calls(fns, tables, k, inp, dev) for name, tables, fns, _ in variants}
    names = [v[0] for v in variants]
    kernels = list(calls[names[0]])

    # Warm up and compare every variant's outputs with the first's.
    diff = {}
    for kern in kernels:
        ref_out = None
        for name in names:
            launch, outs = calls[name][kern]
            if launch():
                raise RuntimeError(f"{name} {kern}: launch failed")
            torch.cuda.synchronize()
            if ref_out is None:
                ref_out = [o.clone() for o in outs]
            else:
                diff[(name, kern)] = max((_rel(o, r) for o, r in zip(outs, ref_out)),
                                         default=None)
    ms = {(n, kern): [] for n in names for kern in kernels}
    lib = {"torch.fft.fft": [], "torch.fft.ifft": []}
    xf, Xf = inp["x"].reshape(B, W), inp["X"].reshape(B, W)
    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]
        for kern in kernels:
            for name in order:
                ms[(name, kern)].append(_time(calls[name][kern][0], args.reps))
        lib["torch.fft.fft"].append(_time(lambda: torch.fft.fft(xf) is None, args.reps))
        lib["torch.fft.ifft"].append(_time(lambda: torch.fft.ifft(Xf) is None, args.reps))
    for kern in kernels:
        for name, _, _, usage in variants:
            u = usage.get(f"fourstep::{kern}") or usage.get(f"fused::{kern}") or {}
            print(json.dumps({"kernel": kern, "variant": name, "ms": ms[(name, kern)],
                              "median_ms": statistics.median(ms[(name, kern)]),
                              "registers": u.get("registers"),
                              "stack": u.get("stack"), "spills": u.get("spill_stores"),
                              "max_rel_diff_vs_first": diff.get((name, kern))}))
    for name, v in lib.items():
        print(json.dumps({"library": name, "B": B, "ms": v,
                          "median_ms": statistics.median(v)}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": card.stdout.strip().splitlines()[0] if card.stdout else None,
                      "rounds": args.rounds, "reps": args.reps,
                      "windows": B, "variants": names}))


if __name__ == "__main__":
    main()
