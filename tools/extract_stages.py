"""Stage decomposition of the fused extraction step at production geometry.

Times CUMULATIVE sub-programs of videoquery.pipeline.extract._extract_step
(each compiled standalone, async-queued reps, one sync), so per-stage cost =
difference of adjacent rows; plus the CNN forward alone. Used to find where
the per-batch milliseconds outside the flow kernel and the ensemble go
(gray/resize glue, tick/stack gathers, preprocess matmuls).

Usage:
  python tools/extract_stages.py [--batch 8] [--reps 8] [--warm_camera own]
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from videoquery.core.profiling import timeit
from videoquery.nn.tsn import TwoStreamTSN
from videoquery.pipeline.extract import (PRODUCTION_TVL1, _ensemble_embed,
                                         _extract_step, _pair_flow)
from videoquery.pipeline.preprocess import preprocess_flow, preprocess_rgb
from videoquery.pipeline.sampling import (flow_pair_plan, flow_warm_plan,
                                          frame_ticks)


def build(batch=8, frames=150, hw=(256, 340), ticks=25, depth=5,
          res_div=2, warm_group=3, dtype="bfloat16", seed=0):
    h, w = hw
    rng = np.random.default_rng(seed)
    frames_u8 = jax.device_put(jnp.asarray(
        rng.integers(0, 255, (batch, frames, h, w, 3), np.uint8)))
    tick_idx = jnp.asarray(frame_ticks(frames, ticks, 1) - 1, jnp.int32)
    pair_idx, stack_pos = flow_pair_plan(frames, ticks, depth)
    sidx = jnp.asarray(stack_pos, jnp.int32)
    pidx = jnp.asarray(pair_idx, jnp.int32)
    warm = None
    if warm_group > 1:
        kp, wp, ws = flow_warm_plan(pair_idx, warm_group)
        if wp.size:
            warm = (jnp.asarray(kp), jnp.asarray(wp), jnp.asarray(ws))
    tsn = TwoStreamTSN.random(jax.random.PRNGKey(0), splits=(1, 2, 3),
                              dtype=jnp.dtype(dtype))
    return frames_u8, tick_idx, sidx, pidx, warm, tsn


def grayscale(frames_u8, res_div, matmul=True):
    # the production path (bf16 matmul-folded by default; --gray_exact
    # times the old f32 gray -> jax.image.resize variant)
    from videoquery.pipeline.extract import _flow_gray_grid
    return _flow_gray_grid(frames_u8, res_div, matmul=matmul)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--res_div", type=int, default=2)
    ap.add_argument("--warm_group", type=int, default=3)
    ap.add_argument("--warm_camera", default="own", choices=["own", "key", "init"])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--gray_exact", action="store_true",
                    help="time the f32 gray -> jax.image.resize path "
                         "instead of the production bf16 matmul fold")
    args = ap.parse_args()
    gray_mm = not args.gray_exact

    frames_u8, tick_idx, sidx, pidx, warm, tsn = build(
        batch=args.batch, res_div=args.res_div, warm_group=args.warm_group,
        dtype=args.dtype)
    tvl1 = PRODUCTION_TVL1
    cam = args.warm_camera

    @jax.jit
    def s_gray(fr):
        gray, _ = grayscale(fr, args.res_div, gray_mm)
        return gray.sum()

    @jax.jit
    def s_flow(fr):
        gray, vscale = grayscale(fr, args.res_div, gray_mm)
        fq = _pair_flow(gray, pidx, 20.0, True, tvl1, vscale, warm, cam)
        return fq.sum(dtype=jnp.int32)

    @jax.jit
    def s_inputs(fr):
        gray, vscale = grayscale(fr, args.res_div, gray_mm)
        fq = _pair_flow(gray, pidx, 20.0, True, tvl1, vscale, warm, cam)
        rgb_ticks = jnp.take(fr, tick_idx, axis=1)
        stacks = jnp.take(fq, sidx.reshape(-1), axis=1)
        b = fr.shape[0]
        t, d = sidx.shape
        fh, fw = fq.shape[2:4]
        stacks = stacks.reshape(b, t, d, fh, fw, 2)
        stacks = stacks.transpose(0, 1, 3, 4, 2, 5).reshape(b, t, fh, fw,
                                                            d * 2)
        dt = jnp.dtype(args.dtype)
        rgb_in = preprocess_rgb(rgb_ticks, (340, 256), 224, dtype=dt)
        flow_in = preprocess_flow(stacks, (340, 256), 224, dtype=dt)
        return (rgb_in.astype(jnp.float32).sum()
                + flow_in.astype(jnp.float32).sum()), rgb_in, flow_in

    @jax.jit
    def s_cnn(rgb_in, flow_in):
        b, t = rgb_in.shape[:2]
        rgb_flat = rgb_in.reshape((b * t,) + rgb_in.shape[2:])
        flow_flat = flow_in.reshape((b * t,) + flow_in.shape[2:])
        r = _ensemble_embed(tsn.rgb.stacked_params, rgb_flat)
        f = _ensemble_embed(tsn.flow.stacked_params, flow_flat)
        return r.astype(jnp.float32).sum() + f.astype(jnp.float32).sum()

    def s_full(fr):
        return _extract_step(
            tsn.rgb.stacked_params, tsn.flow.stacked_params, fr, tick_idx,
            sidx, 20.0, True, tvl1, (340, 256), 224, args.dtype, pidx,
            args.res_div, flow_warm_plan=warm,
            flow_warm_camera=cam, flow_gray_matmul=gray_mm)

    reps = args.reps
    rows = []
    t, _ = timeit(s_gray, frames_u8, reps=reps)
    rows.append(("gray + flow-grid resize", t))
    t, _ = timeit(s_flow, frames_u8, reps=reps)
    rows.append((f"+ warped TV-L1 (warm g{args.warm_group} cam={cam}) + quantize", t))
    t, inp = timeit(s_inputs, frames_u8, reps=reps)
    rows.append(("+ tick/stack gathers + preprocess", t))
    _, rgb_in, flow_in = inp
    t, _ = timeit(s_cnn, rgb_in, flow_in, reps=reps)
    rows.append(("CNN ensemble alone (both streams)", t))
    t, _ = timeit(s_full, frames_u8, reps=reps)
    rows.append(("FULL fused step", t))

    prev = 0.0
    print(f"batch={args.batch} reps={reps} warm_group={args.warm_group} "
          f"cam={cam} dtype={args.dtype}")
    for name, sec in rows:
        ms = sec * 1e3
        delta = "" if name.startswith(("CNN", "FULL")) else f"  (Δ {ms - prev:+.1f} ms)"
        print(f"  {name:55s} {ms:8.1f} ms{delta}")
        if not name.startswith(("CNN", "FULL")):
            prev = ms
    full = rows[-1][1] * 1e3
    rate = args.batch / (rows[-1][1])
    print(f"  => {rate:.1f} clips/s/chip  (inputs {rows[2][1]*1e3:.1f} + cnn "
          f"{rows[3][1]*1e3:.1f} = {rows[2][1]*1e3 + rows[3][1]*1e3:.1f} vs "
          f"full {full:.1f})")


if __name__ == "__main__":
    main()
