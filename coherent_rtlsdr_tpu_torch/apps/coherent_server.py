"""The port's server executable, with the reference binary's CLI letters:

    python3 -m coherent_rtlsdr_tpu_torch.apps.coherent_server \\
        --fft-impl fused -n 21 -b 8192 --scan-depth 32 --blocks 2000
    python3 -m coherent_rtlsdr_tpu_torch.apps.coherent_server --fft-impl fused \\
        --source ring --ingest file:capture.raw@250 --ring-slots 256 -n 21
    python3 -m coherent_rtlsdr_tpu_torch.apps.coherent_server --source rtlsdr \\
        --serials REF,SIG1,SIG2 --hw-drift-relief 8

  -f <hz>     center frequency        -b <n>   block size (complex samples)
  -s <hz>     sample rate             -n <n>   number of channels
  -g <gain>   tuner gain              -r <g>   reference gain
  -A <addr>   data bind address       -C <fn>  channel config file
  -R          raw mode (no header)    -I <ser> reference dongle serial
  -q          stderr -> console `log` drain
  --source synth|file|ring|rtlsdr  --capture <npz>  --ingest <spec>
  --ring-slots <n>  --serials  --rtl-lib  --agc  --hw-drift-relief <samples>
  --blocks <n>  --state <npz>  --drop-rate <p>  --seed <n>  --trace DIR
  --scan-depth  --max-channels  --interactive  --cpu

The ring and rtlsdr sources run on the native host library (``native.py``,
built with g++ at first use). The pipeline runs on the card; ``--cpu`` runs
it on the CPU. ``--mesh > 1`` raises: serving on a mesh comes with the
serving half of ``parallel/``.
"""

import argparse
import contextlib
import dataclasses
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
    ap.add_argument("-g", "--gain", type=float, default=50.0)
    ap.add_argument("-r", "--refgain", type=float, default=50.0)
    ap.add_argument("-A", "--address", default="tcp://*:5555")
    ap.add_argument("--ctrl-address", default="tcp://*:5556")
    ap.add_argument("--debug-address", default="tcp://*:5557")
    ap.add_argument("-C", "--config", default=None)
    ap.add_argument("-R", "--raw", action="store_true")
    ap.add_argument("-I", "--refserial", default=None,
                    help="reference dongle serial: the rtlsdr source puts it first")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="redirect stderr (native librtlsdr writes included) into the "
                         "console `log` drain")
    ap.add_argument("--source", choices=["synth", "file", "ring", "rtlsdr"], default="synth")
    ap.add_argument("--serials", default=None,
                    help="rtlsdr source: comma-separated dongle serials, reference first "
                         "(default: the -C config file's channel map, else USB order)")
    ap.add_argument("--rtl-lib", default=None, metavar="PATH",
                    help="librtlsdr .so to dlopen (default: $COHERENT_LIBRTLSDR, then the "
                         "system's librtlsdr)")
    ap.add_argument("--agc", action="store_true", help="tuner AGC on every dongle")
    ap.add_argument("--hw-drift-relief", type=float, default=None, metavar="SAMPLES",
                    help="rtlsdr source: past this many samples of applied delay, pulse "
                         "that dongle's resampler with the tanh law (io/hwcontrol.py)")
    ap.add_argument("--capture", default=None, help="file source: capture npz")
    ap.add_argument("--ingest", default=None,
                    help="ring source producer: 'file:<path>[@<blocks/s>]' replays a raw "
                         "capture (looping) or 'zmq:<addr>' receives blocks; both run as "
                         "native C++ threads")
    ap.add_argument("--ring-slots", type=int, default=16,
                    help="ring depth in blocks (a power of two; a full ring drops blocks, "
                         "which show as seqnum gaps)")
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
                    help="channel shards over devices (not ported yet: the serving "
                         "half of parallel/)")
    ap.add_argument("--max-channels", type=int, default=None,
                    help="pad the channel axis to this width so console add/del keep "
                         "the same runners")
    return ap


def _rtl_serials(ap, args):
    """The rtlsdr source's dongle serials, reference first, and their
    per-channel gains from the config file (or None)."""
    from coherent_rtlsdr_tpu_torch import native
    from coherent_rtlsdr_tpu_torch.io.config import get_refname, read_config, signal_channels

    if args.rtl_lib or not native.rtlsdr_available():
        if not native.rtlsdr_load(args.rtl_lib):
            ap.error("librtlsdr not found (set --rtl-lib or $COHERENT_LIBRTLSDR)")
    gains_db = None
    if args.serials:
        serials = [s for s in args.serials.split(",") if s]
    elif args.config:
        defs = read_config(args.config)
        sig_defs = signal_channels(defs)
        serials = [get_refname(defs)] + [d.serial for d in sig_defs]
        ref_def = next(d for d in defs if d.devindex == 0)
        gains = [ref_def.gain_db] + [d.gain_db for d in sig_defs]
        if any(g is not None for g in gains):
            gains_db = gains
    else:
        serials = native.rtlsdr_enumerate()
        print(f"enumerated {len(serials)} dongles: {serials}")
    if args.refserial:
        if args.refserial not in serials:
            ap.error(f"-I serial '{args.refserial}' not in {serials}")
        i = serials.index(args.refserial)
        serials.insert(0, serials.pop(i))
        if gains_db is not None:
            gains_db.insert(0, gains_db.pop(i))
    if len(serials) < 2:
        ap.error("the rtlsdr source needs >= 2 dongles (ref + signal)")
    return serials, gains_db


def _ring_source(ap, args, n):
    """A native block ring fed by a file or ZMQ producer thread, and the
    ``RingSource`` that reads it: (source, producer)."""
    from coherent_rtlsdr_tpu_torch import native
    from coherent_rtlsdr_tpu_torch.signal.sources import RingSource

    if not args.ingest:
        ap.error("--source ring requires --ingest file:<path> | zmq:<addr>")
    kind, _, spec = args.ingest.partition(":")
    if kind not in ("file", "zmq"):
        ap.error(f"unknown ingest '{args.ingest}'")
    # One seqnum track per channel: header frames from a ZMQ capture daemon
    # carry each channel's capture seqnums; file replay and raw blocks
    # replicate a frame counter across the tracks.
    ring = native.NativeBlockRing(args.ring_slots, (n + 1) * args.blocksize * 2, n_seq=n + 1)
    if kind == "file":
        path, _, rate = spec.partition("@")
        producer = native.NativeProducer.file(ring, path,
                                              rate_blocks_per_s=float(rate) if rate else 0.0,
                                              loop=True)
    else:
        producer = native.NativeProducer.zmq(ring, spec)
    return RingSource(ring, n_channels=n, block_len=args.blocksize), producer


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh > 1:
        raise NotImplementedError(f"--mesh {LATER_SLICE}")
    if args.hw_drift_relief is not None and args.source != "rtlsdr":
        ap.error("--hw-drift-relief requires --source rtlsdr")

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
    producer = None
    if args.source == "rtlsdr":
        from coherent_rtlsdr_tpu_torch.signal.sources import RtlSource

        serials, gains_db = _rtl_serials(ap, args)
        if len(serials) - 1 != n:
            n = len(serials) - 1
            cfg = dataclasses.replace(cfg, n_channels=n)
        # The source owns the capture handle, so console fcenter / fs /
        # add / del reach the dongles; --max-channels sizes the ring for
        # hot-add.
        source = RtlSource.start(serials, block_len=args.blocksize, ring_slots=args.ring_slots,
                                 max_channels=args.max_channels, fs=args.fs,
                                 fcenter=args.fcenter, gain_db=args.gain,
                                 ref_gain_db=args.refgain, agc=args.agc, gains_db=gains_db)
        producer = source.capture
    elif args.source == "ring":
        source, producer = _ring_source(ap, args, n)
    elif args.source == "file":
        from coherent_rtlsdr_tpu_torch.io.streamio import load_capture
        from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

        source = FileSource(load_capture(args.capture), loop=False)
    else:
        from coherent_rtlsdr_tpu_torch.signal import make_truth
        from coherent_rtlsdr_tpu_torch.signal.sources import SyntheticStreamSource

        truth = make_truth(n, seed=args.seed, max_delay=40.0, snr_db=30.0)
        source = SyntheticStreamSource(truth, block_len=args.blocksize, seed=args.seed,
                                       drop_rate=args.drop_rate, device=device)
    try:
        server = CoherentServer(
            cfg, source, fcenter=args.fcenter, data_addr=args.address,
            ctrl_addr=args.ctrl_address, debug_addr=args.debug_address, header=not args.raw,
            state_path=args.state, scan_depth=args.scan_depth,
            max_channels=args.max_channels, device=device,
        )
        return _serve(args, server, device)
    finally:
        if producer is not None:
            producer.stop()


def _serve(args, server, device) -> int:
    """Run the server until --blocks, the end of the source or a signal,
    then close its sockets."""
    n = server.n_active
    print(f"coherent_rtlsdr_tpu_torch server on {server.device}: {n} ch x "
          f"{args.blocksize} @ {args.fs:.0f} sps, data {args.address}, "
          f"ctrl {args.ctrl_address}")

    def graceful(signum, frame):
        print(f"\nsignal {signum}: shutting down after the current block", flush=True)
        server.request_exit()

    signal.signal(signal.SIGINT, graceful)
    signal.signal(signal.SIGTERM, graceful)
    if args.hw_drift_relief is not None:
        from coherent_rtlsdr_tpu_torch.io.hwcontrol import HwDriftRelief

        server.hw_relief = HwDriftRelief(server.source.capture, fs=args.fs,
                                         threshold=args.hw_drift_relief)
    if args.quiet:
        server.capture_stderr()
    if args.interactive:
        server.start_local_console()
    prof = contextlib.nullcontext()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
    try:
        with prof:
            published = server.run(max_blocks=args.blocks)
    finally:
        server.publisher.close()
        server.control.close()
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace -> {path}")
    print(f"published {published} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
