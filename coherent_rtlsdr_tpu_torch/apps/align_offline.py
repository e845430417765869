"""Offline capture alignment (port of the JAX package's
``apps/align_offline.py``): a capture npz in, an aligned npz and a quality
report out, through the measure -> smooth -> apply engine
(``pipeline/offline.py``).

    python3 -m coherent_rtlsdr_tpu_torch.apps.align_offline capture.npz -o aligned.npz
    python3 -m coherent_rtlsdr_tpu_torch.apps.align_offline --synth 8 --blocks 32 \\
        --fft-impl fused -o aligned.npz

The output npz has the JAX app's layout: ``aligned_i8 [T-1, N, L, 2]``,
``ref_i8 [T-1, L, 2]``, ``delay``, ``mag``, ``papr`` and ``phase [T-1, N]``
(complex) and ``fs``. The engine runs on the card; ``--cpu`` runs it on the
CPU. ``--mesh > 1`` raises: it comes with ``parallel/``.
"""

import argparse

import numpy as np
import torch

from coherent_rtlsdr_tpu_torch.io.server import LATER_SLICE


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("capture", nargs="?", default=None)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--smoothing", choices=["global", "ema"], default="global")
    ap.add_argument("--synth", type=int, default=None,
                    help="align a synthetic capture of this many channels instead")
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--block-len", type=int, default=8192)
    ap.add_argument("--mesh", type=int, default=1, metavar="SHARDS",
                    help="channel shards over devices (not ported yet: parallel/)")
    ap.add_argument("--fft-impl", choices=["xla", "mxu", "pallas", "fused", "auto"],
                    default="xla",
                    help="spectral backend; 'fused' = the i8 measure/apply kernels")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh > 1:
        raise NotImplementedError(f"--mesh {LATER_SLICE}")
    if args.capture is None and not args.synth:
        ap.error("give a capture npz or --synth N")

    from coherent_rtlsdr_tpu_torch.ops.convert import c64_to_i8_iq
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, align_offline

    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("align_offline runs on the card and found none; pass --cpu")
    if args.synth:
        from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture

        truth = make_truth(args.synth, seed=0, max_delay=40.0, snr_db=30.0)
        cap = synth_capture(torch.Generator(device).manual_seed(0), truth,
                            n_blocks=args.blocks, block_len=args.block_len)
        sig_u8, ref_u8, fs = cap.sig_u8, cap.ref_u8, 2.048e6
        print(f"synthetic capture: true delays {truth.delays.round(3)}")
    else:
        from coherent_rtlsdr_tpu_torch.io.streamio import load_capture

        c = load_capture(args.capture)
        sig_u8 = torch.from_numpy(c.sig_u8).to(device)
        ref_u8 = torch.from_numpy(c.ref_u8).to(device)
        fs = c.fs

    T, N, L, _ = sig_u8.shape
    cfg = PipelineConfig(n_channels=N, block_len=L, fft_impl=args.fft_impl,
                         lag_method="phase_zoom" if args.fft_impl == "fused" else "phase_slope")
    if args.fft_impl == "fused":   # the fused kernels take flat bytes
        sig_u8, ref_u8 = sig_u8.reshape(T, N, 2 * L), ref_u8.reshape(T, 2 * L)
    res = align_offline(cfg, sig_u8, ref_u8, smoothing=args.smoothing)
    if res.wire is not None:
        aligned_i8, ref_i8 = res.wire, res.wire_ref
    else:
        aligned_i8, ref_i8 = c64_to_i8_iq(res.aligned), c64_to_i8_iq(res.ref)
    aligned_i8 = aligned_i8.cpu().numpy().reshape(-1, N, L, 2)
    ref_i8 = ref_i8.cpu().numpy().reshape(-1, L, 2)
    delay, mag = res.delay.cpu().numpy(), res.mag.cpu().numpy()
    phase = res.phase.cpu().numpy()

    np.savez_compressed(args.out, aligned_i8=aligned_i8, ref_i8=ref_i8, delay=delay, mag=mag,
                        papr=res.papr.cpu().numpy(), phase=phase, fs=np.float64(fs))
    print(f"aligned {T - 1} blocks x {N} ch -> {args.out}")
    print(f"final delays: {delay[-1].round(3)}")
    print(f"mean corr:    {mag.mean(axis=0).round(3)}")
    ang = np.degrees(np.angle(phase * np.conj(phase.mean(axis=0, keepdims=True))))
    print(f"phase stability (deg RMS over blocks): {np.sqrt(np.mean(ang ** 2)):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
