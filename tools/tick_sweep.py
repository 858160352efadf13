"""Tick-budget scaling curve: clips/s vs retrieval (VERDICT r3 #8).

The 25-tick budget (calcSig_wOF.py:67-72) is the one remaining
order-of-magnitude extraction lever: per-batch cost is ~linear in ticks
(25 ticks -> 125 flow pairs + 200 CNN images per 8-clip batch). Ticks are
a SAMPLING question, not a flow-quality one, so the gate is retrieval:
motion-partner accuracy on the synthetic corpus with PRODUCTION-length
clips (150 frames), swept over num_ticks {25, 15, 10, 5}, against the
measured device throughput at each tick count (bench.bench_extraction).

Run on the chip:  python tools/tick_sweep.py [--seeds 0 1 2] [--scale 1]
Publishes the curve for PERF.md; 25 stays the shipping default.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def embeddings_for_ticks(clips, num_ticks, tsn, chunk=4):
    """Production-path embeddings ([K, C, D] per stream) at a tick budget,
    chunked so 150-frame clip uploads fit comfortably."""
    import jax.numpy as jnp

    from videoquery.core.config import ExtractionConfig
    from videoquery.pipeline.extract import PRODUCTION_TVL1, _extract_step
    from videoquery.pipeline.sampling import (flow_pair_plan, flow_warm_plan,
                                              frame_ticks)

    c, f = clips.shape[:2]
    ticks = jnp.asarray(frame_ticks(f, num_ticks, 1) - 1, jnp.int32)
    pair_idx, stack_pos = flow_pair_plan(f, num_ticks, 5)
    sidx = jnp.asarray(stack_pos, jnp.int32)
    pidx = jnp.asarray(pair_idx, jnp.int32)
    wg = ExtractionConfig().flow_warm_group
    warm = None
    if wg > 1:
        kp, wp, ws = flow_warm_plan(pair_idx, wg)
        if wp.size:
            warm = (jnp.asarray(kp), jnp.asarray(wp), jnp.asarray(ws))
    rgb_all, flow_all = [], []
    for s in range(0, c, chunk):
        part = clips[s:s + chunk]
        if len(part) < chunk:  # keep one compiled geometry
            pad = np.repeat(part[-1:], chunk - len(part), axis=0)
            part = np.concatenate([part, pad], axis=0)
        rgb, flow = _extract_step(
            tsn.rgb.stacked_params, tsn.flow.stacked_params,
            jnp.asarray(part), ticks, sidx, 20.0, True, PRODUCTION_TVL1,
            (340, 256), 224, "float32", pidx, 2,
            flow_warm_plan=warm,
            flow_warm_camera=ExtractionConfig().flow_warm_camera,
        )
        rgb_all.append(np.asarray(rgb, np.float64))
        flow_all.append(np.asarray(flow, np.float64))
    rgb = np.concatenate(rgb_all, axis=1)[:, :c]
    flow = np.concatenate(flow_all, axis=1)[:, :c]
    return rgb, flow


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--ticks", type=int, nargs="+", default=[25, 15, 10, 5])
    ap.add_argument("--frames", type=int, default=150,
                    help="clip length (150 = production 10 s @ 15 fps)")
    ap.add_argument("--no_bench", action="store_true",
                    help="skip the device-throughput measurement")
    args = ap.parse_args()

    import jax

    from videoquery.core.jaxsetup import setup_jax

    setup_jax()
    from tools.flow_quality import make_corpus, partner_accuracy
    from videoquery.nn.tsn import TwoStreamTSN

    tsn = TwoStreamTSN.random(jax.random.PRNGKey(0), splits=(1,))

    acc: dict[int, list] = {t: [] for t in args.ticks}
    acc_rgb: dict[int, list] = {t: [] for t in args.ticks}
    for seed in args.seeds:
        clips, labels = make_corpus(frames=args.frames, seed=seed,
                                    scale=args.scale)
        for t in args.ticks:
            t0 = time.time()
            rgb, flow = embeddings_for_ticks(clips, t, tsn)
            a_flow = partner_accuracy(flow, labels)
            a_rgb = partner_accuracy(rgb, labels)
            acc[t].append(a_flow)
            acc_rgb[t].append(a_rgb)
            print(f"[{time.time()-t0:6.1f}s] seed {seed} ticks={t:2d}  "
                  f"flow retrieval {a_flow:.2f}  rgb {a_rgb:.2f}",
                  flush=True)

    rates = {}
    if not args.no_bench:
        from bench import bench_extraction

        for t in args.ticks:
            rates[t] = bench_extraction(n_batches=6, num_ticks=t)

    print("\n== tick-budget curve (mean over seeds %s, scale %d, %d-frame "
          "clips) ==" % (args.seeds, args.scale, args.frames))
    print(f"{'ticks':>5} {'flow-retr':>9} {'rgb-retr':>8} {'clips/s':>8}")
    for t in args.ticks:
        r = f"{rates[t]:8.1f}" if t in rates else "       -"
        print(f"{t:5d} {np.mean(acc[t]):9.3f} {np.mean(acc_rgb[t]):8.3f} {r}"
              f"   (per-seed {['%.2f' % a for a in acc[t]]})")


if __name__ == "__main__":
    main()
