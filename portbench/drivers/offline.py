"""The offline driver: ``align_offline`` called back to back on captures
already resident on the card.

Traffic parameters (``traffic/<mix>.json``):

* ``capture_samples``: samples a channel of each capture (T = capture_samples
  / L blocks, T - 1 output blocks a call);
* ``captures``: distinct captures rendered at set-up and taken in turn, so
  that the calls do not run out of the L2 cache;
* ``max_ppm``: each channel's residual clock skew is drawn uniformly within
  +-max_ppm, so its delay drifts across a capture and every window reads a
  delay of its own;
* ``smoothing``: ``align_offline``'s smoothing;
* ``in_flight``: calls enqueued ahead of the card (the driver waits for call
  i - in_flight before it issues call i);
* ``sample_calls``: calls whose outputs are kept for the comparison, drawn
  from the seed among those the window is expected to hold, with the first.

The window issues calls until ``--seconds`` have passed and ends on a
``torch.cuda.synchronize()``.
"""

import collections
import time

import numpy as np
import torch

from portbench import synth
from portbench.drivers import pipeline_config
from portbench.reference import align, compare


def capture_seed(seed: int, c: int) -> int:
    return int(np.random.SeedSequence([seed, 0xCA97, c]).generate_state(1, np.uint64)[0] >> 1)


def render_capture(cell, seed: int, c: int, device):
    """Capture ``c`` of a run with ``seed``: (sig_u8 [T, N, L, 2], ref_u8
    [T, L, 2]) on ``device``, slab 0 of the synthetic stream."""
    cfg, tr = cell.config, cell.traffic
    L = cfg["block_len"]
    s = capture_seed(seed, c)
    truth = synth.make_truth(cfg["n_channels"], seed=s, max_delay=cfg["truth_max_delay"],
                             snr_db=cfg["snr_db"], max_ppm=tr["max_ppm"])
    return synth.synth_stream_slab(s, truth, 0, tr["capture_samples"] // L, L,
                                   cfg["amplitude"], device=device)


def run(run):
    from coherent_rtlsdr_tpu_torch.pipeline.offline import align_offline

    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    N, L = cfg["n_channels"], cfg["block_len"]
    T = tr["capture_samples"] // L
    caps = [render_capture(run.cell, run.seed, c, dev) for c in range(tr["captures"])]
    run.reset_memory()
    run.mark("render")
    pcfg = pipeline_config(cfg)
    call = lambda i: align_offline(pcfg, *caps[i % len(caps)], smoothing=tr["smoothing"])

    call(0)
    run.sync()
    run.mark("first call")
    t = time.perf_counter()
    call(1)
    run.sync()
    expect = max(1, int(run.seconds / max(time.perf_counter() - t, 1e-6)))
    rng = np.random.default_rng([run.seed, 0x0FF1])
    keep = {0} | set(rng.choice(expect, size=min(tr["sample_calls"], expect),
                                replace=False).tolist())

    kept, events, i = {}, collections.deque(), 0
    with run.window() as win:
        t_end = win.t0 + run.seconds
        while time.perf_counter() < t_end:
            if len(events) >= tr["in_flight"]:
                events.popleft().synchronize()
            out = call(i)
            ev = torch.cuda.Event() if dev.type == "cuda" else None
            if ev is not None:
                ev.record()
                events.append(ev)
            if i in keep:
                kept[i] = out
            i += 1
        run.sync()
        wall = time.perf_counter() - win.t0
    run.read_memory()
    run.data.update(calls=i, wall_s=wall, T=T, n_channels=N, block_len=L)
    run.attempted, run.failed = i, 0

    r = compare.Readings()
    tf = align.Transform(2 * L, dev, "f64")
    p = align.Params(cfg)
    by_capture = collections.defaultdict(list)
    for j, out in kept.items():
        by_capture[j % len(caps)].append(out)
    for c, outs in sorted(by_capture.items()):
        want = align.align_offline(tf, p, caps[c][0], caps[c][1])
        for out in outs:
            compare.offline(r, out, want)
        del want
    r.count("calls_compared", len(kept))
    return r.values()
