"""Does cross-batch software pipelining buy anything on this backend?

VERDICT r3 #1 hypothesizes that the ~65 ms of flow+preprocess per batch is
"unharvested overlap": dispatch batch N's flow concurrently with batch
N-1's CNN and steady-state cost drops toward max(CNN, flow) = ~93 ms
(86 clips/s) instead of their sum (~157 ms). On a single-TensorCore chip
that only works if the runtime/compiler actually executes independent
programs (or independent subgraphs of one program) concurrently.

This tool measures it three ways at exact production geometry:
  A. fused monolith      — the shipping _extract_step, async-queued
                           (the bench.py timing model; the baseline)
  B. split two-program   — prep (gray->flow->gathers->preprocess) and
                           CNN as separate executables, dispatch
                           interleaved prep[i+1] before cnn[i]. Any win
                           here = the runtime overlaps queued programs.
  C. combined pipelined  — ONE program computing (cnn(prep_prev),
                           prep(frames_i)); the two subgraphs share no
                           data edges, so any intra-program concurrency
                           XLA's scheduler can extract shows up here.

Steady-state ms/batch for each, so the answer is a number, not an
argument; results are recorded in PERF.md.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from videoquery.core.profiling import sync
from videoquery.nn.tsn import TwoStreamTSN
from videoquery.pipeline.extract import (PRODUCTION_TVL1, _ensemble_embed,
                                         _extract_step, _pair_flow,
                                         _flow_gray_grid)
from videoquery.pipeline.preprocess import preprocess_flow, preprocess_rgb
from videoquery.pipeline.sampling import (flow_pair_plan, flow_warm_plan,
                                          frame_ticks)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--res_div", type=int, default=2)
    ap.add_argument("--warm_group", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()

    from videoquery.core.jaxsetup import setup_jax

    setup_jax()

    b, f, h, w = args.batch, 150, 256, 340
    rng = np.random.default_rng(0)
    frames = jax.device_put(jnp.asarray(
        rng.integers(0, 255, (b, f, h, w, 3), np.uint8)))
    tick_idx = jnp.asarray(frame_ticks(f, 25, 1) - 1, jnp.int32)
    pair_idx, stack_pos = flow_pair_plan(f, 25, 5)
    sidx = jnp.asarray(stack_pos, jnp.int32)
    pidx = jnp.asarray(pair_idx, jnp.int32)
    kp, wp_, ws = flow_warm_plan(pair_idx, args.warm_group)
    warm = (jnp.asarray(kp), jnp.asarray(wp_), jnp.asarray(ws)) \
        if wp_.size else None
    tsn = TwoStreamTSN.random(jax.random.PRNGKey(0), splits=(1, 2, 3),
                              dtype=jnp.dtype(args.dtype))
    tvl1 = PRODUCTION_TVL1
    dt_ = jnp.dtype(args.dtype)

    def prep_fn(fr):
        gray, vscale = _flow_gray_grid(fr, args.res_div, matmul=True)
        fq = _pair_flow(gray, pidx, 20.0, True, tvl1, vscale, warm, "key")
        rgb_ticks = jnp.take(fr, tick_idx, axis=1)
        stacks = jnp.take(fq, sidx.reshape(-1), axis=1)
        t, d = sidx.shape
        fh, fw = fq.shape[2:4]
        stacks = stacks.reshape(b, t, d, fh, fw, 2)
        stacks = stacks.transpose(0, 1, 3, 4, 2, 5).reshape(b, t, fh, fw,
                                                            d * 2)
        rgb_in = preprocess_rgb(rgb_ticks, (340, 256), 224, dtype=dt_)
        flow_in = preprocess_flow(stacks, (340, 256), 224, dtype=dt_)
        return (rgb_in.reshape((b * t,) + rgb_in.shape[2:]),
                flow_in.reshape((b * t,) + flow_in.shape[2:]))

    def cnn_fn(rgb_flat, flow_flat):
        r = _ensemble_embed(tsn.rgb.stacked_params, rgb_flat)
        fl = _ensemble_embed(tsn.flow.stacked_params, flow_flat)
        t = tick_idx.shape[0]
        k = r.shape[0]
        return (r.reshape(k, b, t, -1).mean(axis=2),
                fl.reshape(k, b, t, -1).mean(axis=2))

    prep_j = jax.jit(prep_fn)
    cnn_j = jax.jit(cnn_fn)

    def pipe_fn(fr, carry):
        # one program: CNN of the PREVIOUS batch + prep of this one.
        # No data edges between the subgraphs.
        emb = cnn_fn(*carry)
        return emb, prep_fn(fr)

    pipe_j = jax.jit(pipe_fn)

    def fused(fr):
        return _extract_step(
            tsn.rgb.stacked_params, tsn.flow.stacked_params, fr, tick_idx,
            sidx, 20.0, True, tvl1, (340, 256), 224, args.dtype, pidx,
            args.res_div, flow_warm_plan=warm,
            flow_warm_camera="key")

    reps = args.reps

    # --- A. fused monolith (bench.py timing model) -------------------------
    sync(fused(frames))
    t0 = time.perf_counter()
    outs = [fused(frames) for _ in range(reps)]
    sync(outs[-1])
    a_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"A fused monolith        : {a_ms:7.1f} ms/batch "
          f"({args.batch / a_ms * 1e3:5.1f} clips/s)")

    # --- component times (for the max() target) ----------------------------
    prep0 = prep_j(frames)
    sync(prep0)
    t0 = time.perf_counter()
    ps = [prep_j(frames) for _ in range(reps)]
    sync(ps[-1])
    p_ms = (time.perf_counter() - t0) / reps * 1e3
    sync(cnn_j(*prep0))
    t0 = time.perf_counter()
    cs = [cnn_j(*prep0) for _ in range(reps)]
    sync(cs[-1])
    c_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"  prep alone {p_ms:7.1f} ms, cnn alone {c_ms:7.1f} ms "
          f"(sum {p_ms + c_ms:.1f}, max {max(p_ms, c_ms):.1f} "
          f"= {args.batch / max(p_ms, c_ms) * 1e3:.1f} clips/s if overlapped)")

    # --- B. split two-program, interleaved dispatch ------------------------
    sync(cnn_j(*prep_j(frames)))
    t0 = time.perf_counter()
    carry = prep_j(frames)
    embs = []
    for _ in range(reps):
        nxt = prep_j(frames)   # queued ahead of the cnn below
        embs.append(cnn_j(*carry))
        carry = nxt
    sync(embs[-1])
    b_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"B split 2-prog interleave: {b_ms:6.1f} ms/batch "
          f"({args.batch / b_ms * 1e3:5.1f} clips/s)")

    # --- C. combined pipelined single program ------------------------------
    emb, carry = pipe_j(frames, prep0)
    sync(emb)
    t0 = time.perf_counter()
    embs = []
    for _ in range(reps):
        emb, carry = pipe_j(frames, carry)
        embs.append(emb)
    sync(embs[-1])
    c2_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"C combined pipelined    : {c2_ms:7.1f} ms/batch "
          f"({args.batch / c2_ms * 1e3:5.1f} clips/s)")

    best = min(a_ms, b_ms, c2_ms)
    tgt = max(p_ms, c_ms)
    print(f"=> best {best:.1f} ms vs overlap-ideal {tgt:.1f} ms: "
          + ("OVERLAP EXISTS — adopt the winning schedule"
         if best < 0.9 * a_ms else
         "no cross-subgraph concurrency on this backend (sequential core)"))


if __name__ == "__main__":
    main()
