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
CPU.

``--mesh S`` shards the channels over S ranks
(``parallel/sharded.py:make_channel_sharded_align``: each rank aligns its
channel slice, no collective); S must divide N and the smoothing must be
``global``. Rank 0 gathers the wire bytes, delays and magnitudes and writes
``aligned_i8``, ``ref_i8``, ``delay``, ``mag`` and ``fs``. Under torchrun
(``torchrun --nproc-per-node S -m coherent_rtlsdr_tpu_torch.apps.align_offline
... --mesh S``) the ranks are torchrun's; run alone, the app starts its S
ranks itself, joined through a file in a temporary directory. Ranks on the
card talk over NCCL when each has a card of its own and over gloo when
they share one; ``--cpu`` ranks over gloo.
"""

import argparse
import os
import sys

import numpy as np
import torch

MODULE = "coherent_rtlsdr_tpu_torch.apps.align_offline"


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
                    help="shard the channel axis over this many ranks "
                         "(make_channel_sharded_align); n_channels must divide evenly")
    ap.add_argument("--fft-impl", choices=["xla", "mxu", "pallas", "fused", "auto"],
                    default="xla",
                    help="spectral backend; 'fused' = the i8 measure/apply kernels")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    return ap


def _load(args, device):
    """The capture's (sig_u8 [T, N, L, 2], ref_u8 [T, L, 2], fs) on
    ``device``."""
    if args.synth:
        from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture

        truth = make_truth(args.synth, seed=0, max_delay=40.0, snr_db=30.0)
        cap = synth_capture(torch.Generator(device).manual_seed(0), truth,
                            n_blocks=args.blocks, block_len=args.block_len)
        print(f"synthetic capture: true delays {truth.delays.round(3)}")
        return cap.sig_u8, cap.ref_u8, 2.048e6
    from coherent_rtlsdr_tpu_torch.io.streamio import load_capture

    c = load_capture(args.capture)
    return torch.from_numpy(c.sig_u8).to(device), torch.from_numpy(c.ref_u8).to(device), c.fs


def _align_on_mesh(cfg, args, sig_u8, ref_u8, fs) -> int:
    """This rank's part of ``--mesh``: its channel slice through
    ``make_channel_sharded_align``; rank 0 gathers and writes the npz."""
    import torch.distributed as dist

    from coherent_rtlsdr_tpu_torch.parallel.mesh import gather_to_rank0, local_shard, make_mesh
    from coherent_rtlsdr_tpu_torch.parallel.sharded import make_channel_sharded_align

    T, N, L, _ = sig_u8.shape
    try:
        mesh = make_mesh(1, args.mesh)
        if dist.get_world_size() != args.mesh:
            raise ValueError(f"--mesh {args.mesh} needs a world of {args.mesh} ranks, "
                             f"got {dist.get_world_size()}")
        if args.fft_impl == "fused":   # the fused kernels take flat bytes
            sig_u8, ref_u8 = sig_u8.reshape(T, N, 2 * L), ref_u8.reshape(T, 2 * L)
        run = make_channel_sharded_align(cfg, mesh)
        wire, delay, mag = run(local_shard(sig_u8, mesh, time_sharded=False).contiguous(),
                               ref_u8)
        wire, delay, mag = (gather_to_rank0(x, mesh) for x in (wire, delay, mag))
    finally:
        dist.destroy_process_group()
    if wire is None:
        return 0
    aligned_i8 = wire.cpu().numpy().reshape(-1, N, L, 2)
    delay, mag = delay.cpu().numpy(), mag.cpu().numpy()
    # The reference channel is its own timebase: its wire bytes are the
    # overlap-save window centres of the raw bytes (the JAX app's schema).
    rfull = (ref_u8.reshape(T, L, 2).cpu().numpy().astype(np.int16) - 128).astype(np.int8)
    ref_i8 = np.concatenate([rfull[:-1, L // 2:], rfull[1:, : L // 2]], axis=1)
    np.savez_compressed(args.out, aligned_i8=aligned_i8, ref_i8=ref_i8, delay=delay, mag=mag,
                        fs=np.float64(fs))
    print(f"aligned {aligned_i8.shape[0]} blocks x {N} ch over a {args.mesh}-rank channel "
          f"mesh -> {args.out}")
    print(f"final delays: {delay[-1].round(3)}")
    print(f"mean corr:    {mag.mean(axis=0).round(3)}")
    return 0


def main(argv=None) -> int:
    ap = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.capture is None and not args.synth:
        ap.error("give a capture npz or --synth N")
    if args.mesh > 1:
        if args.smoothing != "global":
            ap.error("--mesh supports --smoothing global only (the channel-sharded engine "
                     "smooths globally per slab)")
        if not any(v in os.environ for v in ("COORDINATOR_ADDRESS", "MASTER_ADDR")):
            from coherent_rtlsdr_tpu_torch.parallel.distributed import spawn_ranks

            return spawn_ranks(MODULE, args.mesh, argv)

    from coherent_rtlsdr_tpu_torch.ops.convert import c64_to_i8_iq
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig, align_offline

    if args.mesh > 1:
        from coherent_rtlsdr_tpu_torch.parallel.distributed import init_multihost

        init_multihost(device_type="cpu" if args.cpu else "cuda")
    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("align_offline runs on the card and found none; pass --cpu")
    else:
        device = torch.device("cuda", torch.cuda.current_device())
    sig_u8, ref_u8, fs = _load(args, device)

    T, N, L, _ = sig_u8.shape
    cfg = PipelineConfig(n_channels=N, block_len=L, fft_impl=args.fft_impl,
                         lag_method="phase_zoom" if args.fft_impl == "fused" else "phase_slope")
    if args.mesh > 1:
        if N % args.mesh:
            ap.error(f"--mesh {args.mesh} must divide n_channels={N}")
        return _align_on_mesh(cfg, args, sig_u8, ref_u8, fs)
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
