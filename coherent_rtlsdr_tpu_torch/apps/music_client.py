"""MUSIC heatmap client (port of the JAX package's ``apps/music_client.py``)
— the beamformclient/heatmap2d2.cpp analog.

Subscribes to the aligned-frame stream (:5555, reference wire format),
accumulates snapshots, and computes a MUSIC (or Bartlett/MVDR) pseudospectrum
heatmap over the (u, v) direction-cosine grid; saves .npy and prints an
ASCII rendering.

``--follow`` is the production continuous mode (heatmap2d2.cpp:156-346's
recv-thread/plot-thread loop): it keeps re-collecting ``--frames`` frames and
re-rendering the heatmap until killed. ``--mat FILE`` saves the last received
snapshot matrix as a MATLAB file with heatmap2d2's matsave variable layout
(heatmap2d2.cpp:229-252: ``x`` complex single + ``time`` string), plus the
computed pseudospectrum ``P``.

The spectrum runs on the card (``coherent_rtlsdr_tpu_torch.models``);
``--cpu`` runs it on the CPU. After each peak line the client prints the
spectrum's wall time (upload of the snapshots to the spectrum back on the
host).

Usage:
  python3 -m coherent_rtlsdr_tpu_torch.apps.music_client -a tcp://127.0.0.1:5555 \\
      --rows 7 --cols 3 --frames 16 --sources 1 -o heatmap.npy
  python3 -m coherent_rtlsdr_tpu_torch.apps.music_client --follow --frames 8 --rows 7 --cols 3
"""

import argparse
import os
import sys
import time

import numpy as np


def ascii_heatmap(P, width=60, height=24):
    h, w = P.shape
    ys = np.linspace(0, h - 1, height).astype(int)
    xs = np.linspace(0, w - 1, width).astype(int)
    Q = 10 * np.log10(P[np.ix_(ys, xs)] / P.max() + 1e-12)
    chars = " .:-=+*#%@"
    lo, hi = -30.0, 0.0
    idx = ((Q - lo) / (hi - lo) * (len(chars) - 1)).clip(0, len(chars) - 1)
    return "\n".join("".join(chars[int(c)] for c in row) for row in idx)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-a", "--address", default="tcp://127.0.0.1:5555")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--rows", type=int, default=7)
    ap.add_argument("--cols", type=int, default=3)
    ap.add_argument("--spacing", type=float, default=0.5)
    ap.add_argument("--sources", type=int, default=1)
    ap.add_argument("--method", choices=["music", "bartlett", "mvdr"], default="music")
    ap.add_argument(
        "--coarray", default=None, metavar="BXxBY",
        help="sparse-array co-array MUSIC (DA2D.m pipeline): augment the "
             "covariance over a filled BXxBY virtual URA and scan MUSIC on "
             "it — resolves more sources than physical sensors. Requires "
             "--positions.",
    )
    ap.add_argument(
        "--positions", default=None,
        help="physical sensor INTEGER grid positions for --coarray: "
             "'x0,y0;x1,y1;...' or a .npy file of shape [N, 2]",
    )
    ap.add_argument("--grid", type=int, default=100)
    ap.add_argument("-o", "--out", default="heatmap.npy")
    ap.add_argument(
        "--follow", action="store_true",
        help="continuous mode: keep collecting --frames frames and "
             "re-rendering until killed (heatmap2d2.cpp recv/plot loop)",
    )
    ap.add_argument(
        "--mat", default=None, metavar="FILE",
        help="also save the snapshot matrix as MATLAB FILE "
             "(variables x, time — heatmap2d2.cpp matsave layout — plus P)",
    )
    ap.add_argument(
        "--plot", default=None, metavar="FILE_OR_SHOW",
        help="live graphical heatmap (heatmap2d2.cpp's gnuplot pm3d "
             "surface, matplotlib edition): 'show' opens an interactive "
             "window re-drawn per --follow iteration; any other value is "
             "a PNG path re-written atomically per iteration (works "
             "display-less via the Agg backend)",
    )
    ap.add_argument("--timeout-ms", type=int, default=600000)
    ap.add_argument("--cpu", action="store_true", help="compute the spectrum on the CPU")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    import torch
    import zmq

    from coherent_rtlsdr_tpu_torch.io.wire import frame_to_matrix, unpack_frame
    from coherent_rtlsdr_tpu_torch.models import (
        bartlett_spectrum,
        coarray_music_spectrum,
        music_spectrum,
        mvdr_spectrum,
        sample_covariance,
        steering_vectors,
        ura_positions,
        uv_grid,
    )

    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("music_client computes on the card and found none; pass --cpu")

    gpos = None
    if args.coarray:
        if not args.positions:
            ap.error("--coarray requires --positions")
        if args.positions.endswith(".npy"):
            gpos = np.load(args.positions).astype(np.int64)
        else:
            gpos = np.asarray(
                [[int(c) for c in p.split(",")] for p in args.positions.split(";")],
                np.int64,
            )

    ctx = zmq.Context()
    sub = ctx.socket(zmq.SUB)
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    sub.setsockopt(zmq.RCVTIMEO, args.timeout_ms)
    sub.connect(args.address)

    uv, ax_t = uv_grid(args.grid, device=device)
    ax = ax_t.cpu().numpy()

    def collect():
        """Accumulate --frames frames; returns ([N-1, frames*L] matrix)."""
        snaps = []
        for _ in range(args.frames):
            frame = unpack_frame(sub.recv())
            X = frame_to_matrix(frame)  # [N, L]; channel 0 = reference
            snaps.append(X[1:])         # beamform the signal channels
        return np.concatenate(snaps, axis=-1)

    def spectrum(X):
        """The [grid, grid] spectrum on the host and its wall time (ms),
        upload included."""
        t0 = time.perf_counter()
        n = X.shape[0]
        R = sample_covariance(torch.from_numpy(X).to(device))
        if args.coarray:
            bx, by = (int(v) for v in args.coarray.lower().split("x"))
            if len(gpos) != n:
                print(f"warning: {n} channels != {len(gpos)} positions")
            P = coarray_music_spectrum(
                R, gpos[:n], (bx, by), uv, args.sources, spacing=args.spacing
            )
        else:
            pos = ura_positions(args.rows, args.cols, args.spacing)[:n]
            A = steering_vectors(pos, uv)
            if args.method == "music":
                P = music_spectrum(R, A, args.sources)
            elif args.method == "bartlett":
                P = bartlett_spectrum(R, A)
            else:
                P = mvdr_spectrum(R, A)
        P = P.cpu().numpy().reshape(args.grid, args.grid)
        return P, (time.perf_counter() - t0) * 1e3

    def _atomic(path, write_fn):
        # Saves re-run every --follow iteration and the process may be
        # SIGTERMed mid-write; a truncated .npy/.mat must never land.
        tmp = path + ".tmp"
        write_fn(tmp)
        os.replace(tmp, path)

    def _save_npy(path, P):
        with open(path, "wb") as f:  # file object: np.save won't append .npy
            np.save(f, P)

    plot_state = {}
    if args.plot:
        import matplotlib

        if args.plot != "show":
            matplotlib.use("Agg")  # PNG mode renders display-less
        import matplotlib.pyplot as plt

        plot_state["plt"] = plt

    def render_plot(P, it):
        """The heatmap2d2.cpp live-surface analog (its gnuplot pm3d replot
        loop, beamformclient/heatmap2d2.cpp:265-346): one persistent
        figure, data swapped per iteration."""
        plt = plot_state["plt"]
        ext = float(ax[0]), float(ax[-1])
        if "im" not in plot_state:
            fig, axp = plt.subplots(figsize=(6, 5))
            im = axp.imshow(
                10 * np.log10(np.maximum(P / P.max(), 1e-12)),
                origin="lower", extent=(*ext, *ext), cmap="inferno",
                vmin=-30, vmax=0, aspect="equal",
            )
            fig.colorbar(im, ax=axp, label="dB")
            axp.set_xlabel("u = sin θ cos φ")
            axp.set_ylabel("v = sin θ sin φ")
            plot_state.update(fig=fig, axp=axp, im=im)
            if args.plot == "show":
                plt.ion()
                fig.show()
        else:
            plot_state["im"].set_data(
                10 * np.log10(np.maximum(P / P.max(), 1e-12))
            )
        plot_state["axp"].set_title(
            f"{args.method} spectrum" + (f"  [{it}]" if it is not None else "")
        )
        if args.plot == "show":
            plot_state["fig"].canvas.draw_idle()
            plot_state["plt"].pause(0.001)
        else:
            _atomic(args.plot, lambda p: plot_state["fig"].savefig(
                p, dpi=90, format="png"))  # tmp path has no .png suffix

    def render(P, ms, it=None):
        _atomic(args.out, lambda p: _save_npy(p, P))
        i = int(P.argmax())
        u = float(ax[i % args.grid])
        v = float(ax[i // args.grid])
        if args.follow:
            sys.stdout.write("\x1b[2J\x1b[H")  # clear screen, home cursor
        print(ascii_heatmap(P))
        tag = f"[{it}] " if it is not None else ""
        print(f"{tag}peak at (u, v) = ({u:+.3f}, {v:+.3f}); saved {args.out}",
              flush=True)
        print(f"{tag}{args.method if not args.coarray else 'coarray music'} spectrum "
              f"{ms:.3f} ms on {device.type}", flush=True)
        if args.plot:
            render_plot(P, it)

    def save_mat(X, P):
        from scipy.io import savemat

        _atomic(args.mat, lambda p: savemat(
            p, {"x": X.T.astype(np.complex64), "P": P,
                "time": time.strftime("%c")}, appendmat=False))

    X = collect()
    n = X.shape[0]
    if not args.coarray and n != args.rows * args.cols:
        print(f"warning: {n} channels != {args.rows}x{args.cols} array")
    P, ms = spectrum(X)
    render(P, ms, it=0 if args.follow else None)
    if args.mat:
        save_mat(X, P)

    it = 0
    while args.follow:
        it += 1
        try:
            X = collect()
        except KeyboardInterrupt:
            break
        P, ms = spectrum(X)
        render(P, ms, it=it)
        if args.mat:
            save_mat(X, P)


if __name__ == "__main__":
    main()
