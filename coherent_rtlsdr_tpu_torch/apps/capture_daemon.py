"""Capture daemon (port of the JAX package's ``apps/capture_daemon.py``):
publish raw sample blocks from a capture host to a remote pipeline host.

The dongles (or a replayed capture, or the synthetic stream) sit on a
capture host near the antennas; the pipeline host runs the server with
``--source ring --ingest zmq:<this daemon>``, whose native C++ SUB thread
receives the blocks straight into its ring.

    python3 -m coherent_rtlsdr_tpu_torch.apps.capture_daemon -n 4 -b 8192 -A "tcp://*:5554"
    python3 -m coherent_rtlsdr_tpu_torch.apps.capture_daemon --source rtlsdr -C array.cfg
    # pipeline host:
    python3 -m coherent_rtlsdr_tpu_torch.apps.coherent_server --source ring \\
        --ingest zmq:tcp://cap:5554 -n 4

Wire (one ZMQ PUB message a block, reference channel first, then the N
signal channels: the ring's slot layout):

  * ``--wire header`` (default): the wire frame of ``io/wire.py`` (hdr0
    {gseq, N+1, L} + a uint32 capture seqnum a channel + int8 IQ), so a
    drop on this host gaps exactly that channel downstream;
  * ``--wire raw``: header-less ``(N+1) * L * 2`` uint8 bytes; the
    receiver counts frames itself and cannot see upstream drops.

The synthetic stream renders on the card unless ``--cpu`` is given. The
publisher is pyzmq's.
"""

import argparse
import time

import numpy as np


def _paced_blocks(src, rate):
    """A rate-paced generator over a block source: ``(frame_u8 [N+1, L, 2],
    seqnums [N+1] uint32)``, the reference channel first with its own frame
    counter, the signal channels with the source's capture seqnums."""

    def blocks():
        period = 1.0 / rate
        nxt = time.monotonic()
        ref_seq = 0
        while True:
            blk = src.next_block()
            if blk is None:
                return
            sig, ref, seqs = blk
            ref_seq += 1
            nxt += period
            time.sleep(max(0.0, nxt - time.monotonic()))
            frame = np.concatenate([np.asarray(ref)[None], np.asarray(sig)], axis=0)
            yield frame, np.concatenate([[np.uint32(ref_seq)], np.asarray(seqs, np.uint32)])

    return blocks


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--nchannels", type=int, default=4)
    ap.add_argument("-b", "--blocksize", type=int, default=8192)
    ap.add_argument("-s", "--fs", type=float, default=2.048e6)
    ap.add_argument("-f", "--fcenter", type=float, default=1024e6)
    ap.add_argument("-g", "--gain", type=float, default=50.0)
    ap.add_argument("-r", "--refgain", type=float, default=50.0)
    ap.add_argument("-A", "--address", default="tcp://*:5554")
    ap.add_argument("-C", "--config", default=None)
    ap.add_argument("--source", choices=["synth", "file", "rtlsdr"], default="synth")
    ap.add_argument("--capture", default=None, help="file source: capture npz")
    ap.add_argument("--serials", default=None,
                    help="rtlsdr: comma-separated serials, reference first")
    ap.add_argument("--rtl-lib", default=None)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="blocks/s pacing (synth/file; 0 = real time, fs / L)")
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wire", choices=["header", "raw"], default="header",
                    help="header = wire frames with each channel's seqnum; raw = "
                         "header-less blocks")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="synth: per-channel block drop injection")
    ap.add_argument("--cpu", action="store_true", help="render the synthetic stream on the CPU")
    return ap


def _rtlsdr_blocks(ap, args, L):
    """Frames straight from the dongles' native capture: (capture, n,
    generator)."""
    from coherent_rtlsdr_tpu_torch import native
    from coherent_rtlsdr_tpu_torch.io.config import get_refname, read_config, signal_channels

    if args.rtl_lib or not native.rtlsdr_available():
        if not native.rtlsdr_load(args.rtl_lib):
            ap.error("librtlsdr not found")
    if args.serials:
        serials = [s for s in args.serials.split(",") if s]
    elif args.config:
        defs = read_config(args.config)
        serials = [get_refname(defs)] + [d.serial for d in signal_channels(defs)]
    else:
        serials = native.rtlsdr_enumerate()
    n = len(serials) - 1
    # per-channel seqnum tracks: the dongles' capture order rides the wire
    # in header mode
    ring = native.NativeBlockRing(16, (n + 1) * L * 2, n_seq=n + 1)
    capture = native.NativeRtlCapture(ring, serials, block_len=L, fs=args.fs,
                                      fcenter=args.fcenter, gain_db=args.gain,
                                      ref_gain_db=args.refgain)

    def blocks():
        while True:
            out = ring.pop_n(timeout_ms=5000)
            if out is None:
                if not capture.running:
                    return
                continue
            buf, seqs64, _ts = out
            yield buf.reshape(n + 1, L, 2), seqs64[: n + 1].astype(np.uint32)

    return capture, n, blocks


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    import zmq

    n, L = args.nchannels, args.blocksize
    rate = args.rate if args.rate > 0 else args.fs / L
    capture = None
    if args.source == "rtlsdr":
        capture, n, blocks = _rtlsdr_blocks(ap, args, L)
    elif args.source == "file":
        from coherent_rtlsdr_tpu_torch.io.streamio import load_capture
        from coherent_rtlsdr_tpu_torch.signal.sources import FileSource

        blocks = _paced_blocks(FileSource(load_capture(args.capture), loop=True), rate)
    else:
        from coherent_rtlsdr_tpu_torch.signal import make_truth
        from coherent_rtlsdr_tpu_torch.signal.sources import SyntheticStreamSource

        truth = make_truth(n, seed=args.seed, max_delay=40.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, seed=args.seed,
                                    drop_rate=args.drop_rate,
                                    device="cpu" if args.cpu else "cuda")
        blocks = _paced_blocks(src, rate)

    header = args.wire == "header"
    if header:
        from coherent_rtlsdr_tpu_torch.io.wire import pack_frame

    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.bind(args.address)
    print(f"capture daemon: {n}+1 ch x {L} -> PUB {args.address} "
          f"({args.source}, {args.wire} wire, {rate:.1f} blocks/s)", flush=True)
    sent = 0
    try:
        for frame_u8, seqs in blocks():
            if header:
                # the wire payload is signed int8 (u8 ^ 0x80)
                iq = (np.ascontiguousarray(frame_u8) ^ np.uint8(0x80)).view(np.int8)
                buf = pack_frame(sent, seqs, iq)
            else:
                buf = np.ascontiguousarray(frame_u8).tobytes()
            pub.send(buf)
            sent += 1
            if args.blocks is not None and sent >= args.blocks:
                break
    except KeyboardInterrupt:
        pass
    finally:
        if capture is not None:
            capture.stop()
        pub.close(0)
        ctx.term()
    print(f"published {sent} blocks", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
