"""The port's server executable, with the reference binary's CLI letters
for what the synthetic and file sources use:

    python3 -m coherent_rtlsdr_tpu_torch.apps.coherent_server \\
        --fft-impl fused -n 21 -b 8192 --scan-depth 32 --blocks 2000

  -f <hz>     center frequency        -b <n>   block size (complex samples)
  -s <hz>     sample rate             -n <n>   number of channels
  -A <addr>   data bind address       -C <fn>  channel config file
  -R          raw mode (no header)    -q       stderr -> console `log` drain
  --source synth|file  --capture <npz>  --blocks <n>  --state <npz>
  --drop-rate <p>  --seed <n>  --trace DIR  --scan-depth  --max-channels
  --interactive  --cpu

The pipeline runs on the card; ``--cpu`` runs it on the CPU. ``--source
ring|rtlsdr``, ``--hw-drift-relief`` and ``--mesh > 1`` raise: they come
with the port's native host slice and ``parallel/``.
"""

import argparse
import contextlib
import os
import signal

from coherent_rtlsdr_tpu_torch.io.server import LATER_SLICE


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-f", "--fcenter", type=float, default=1024e6)
    ap.add_argument("-b", "--blocksize", type=int, default=8192)
    ap.add_argument("-s", "--fs", type=float, default=2.048e6)
    ap.add_argument("-n", "--nchannels", type=int, default=4)
    ap.add_argument("-A", "--address", default="tcp://*:5555")
    ap.add_argument("--ctrl-address", default="tcp://*:5556")
    ap.add_argument("--debug-address", default="tcp://*:5557")
    ap.add_argument("-C", "--config", default=None)
    ap.add_argument("-R", "--raw", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="redirect stderr into the console `log` drain")
    ap.add_argument("--source", choices=["synth", "file", "ring", "rtlsdr"], default="synth")
    ap.add_argument("--hw-drift-relief", type=float, default=None, metavar="SAMPLES",
                    help="rtlsdr source only (not ported yet)")
    ap.add_argument("--capture", default=None, help="file source: capture npz")
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--state", default=None, help="calibration checkpoint npz")
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run the pipeline on the CPU")
    ap.add_argument("--scan-depth", type=int, default=1,
                    help="blocks per runner call (throughput mode; adds latency)")
    ap.add_argument("--interactive", action="store_true",
                    help="local stdin console next to the remote socket")
    ap.add_argument("--fft-impl", choices=["xla", "mxu", "pallas", "fused", "auto"],
                    default="xla",
                    help="spectral backend (kernels/backend.py); 'fused' = the u8-native "
                         "measure/apply kernels")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the loop to DIR/trace.json")
    ap.add_argument("--mesh", type=int, default=1, metavar="SHARDS",
                    help="channel shards over devices (not ported yet)")
    ap.add_argument("--max-channels", type=int, default=None,
                    help="pad the channel axis to this width so console add/del keep "
                         "the same runners")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.source in ("ring", "rtlsdr"):
        raise NotImplementedError(f"--source {args.source} {LATER_SLICE}")
    if args.hw_drift_relief is not None:
        raise NotImplementedError(f"--hw-drift-relief {LATER_SLICE}")
    if args.mesh > 1:
        raise NotImplementedError(f"--mesh {LATER_SLICE}")

    from coherent_rtlsdr_tpu_torch.io.config import read_config, signal_channels
    from coherent_rtlsdr_tpu_torch.io.server import CoherentServer
    from coherent_rtlsdr_tpu_torch.pipeline import PipelineConfig

    device = "cpu" if args.cpu else "cuda"
    n = args.nchannels
    if args.config:
        n = len(signal_channels(read_config(args.config)))
        print(f"config {args.config}: {n} signal channels")
    cfg = PipelineConfig(
        n_channels=n, block_len=args.blocksize, fs=args.fs, fft_impl=args.fft_impl,
        lag_method="phase_zoom" if args.fft_impl == "fused" else "phase_slope",
    )
    if args.source == "file":
        from coherent_rtlsdr_tpu_torch.io.streamio import load_capture
        from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

        source = FileSource(load_capture(args.capture), loop=False)
    else:
        from coherent_rtlsdr_tpu_torch.signal import make_truth
        from coherent_rtlsdr_tpu_torch.signal.sources import SyntheticStreamSource

        truth = make_truth(n, seed=args.seed, max_delay=40.0, snr_db=30.0)
        source = SyntheticStreamSource(truth, block_len=args.blocksize, seed=args.seed,
                                       drop_rate=args.drop_rate, device=device)
    server = CoherentServer(
        cfg, source, fcenter=args.fcenter, data_addr=args.address,
        ctrl_addr=args.ctrl_address, debug_addr=args.debug_address, header=not args.raw,
        state_path=args.state, scan_depth=args.scan_depth,
        max_channels=args.max_channels, device=device,
    )
    print(f"coherent_rtlsdr_tpu_torch server on {server.device}: {n} ch x "
          f"{args.blocksize} @ {args.fs:.0f} sps, data {args.address}, "
          f"ctrl {args.ctrl_address}")

    def graceful(signum, frame):
        print(f"\nsignal {signum}: shutting down after the current block", flush=True)
        server.request_exit()

    signal.signal(signal.SIGINT, graceful)
    signal.signal(signal.SIGTERM, graceful)
    if args.quiet:
        server.capture_stderr()
    if args.interactive:
        server.start_local_console()
    prof = contextlib.nullcontext()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
    with prof:
        published = server.run(max_blocks=args.blocks)
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace -> {path}")
    print(f"published {published} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
