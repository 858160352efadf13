"""Bring-up measurements on one GPU, each printed as one line of JSON:

  level    — _tvl1_level per pyramid level at the production grid and batch
             (8 clips: the keyframe pairs of flow_pair_plan(150, 25, 5) at
             every level, the warm pairs' one refinement level);
  stem     — the 6-member ensemble forward (200 images per stream, bf16)
             with the space-to-depth stem against the plain 7x7/s2 conv;
  query    — _local_query, Q=16 over 1M bf16 segments, against the
             12.3 GB / 3.35 TB/s memory floor.

Run: python tools/bringup_measure.py [--only level stem query]
Timings queue --reps calls and wait once (jax.block_until_ready), after an
untimed call that compiles.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from videoquery.core.profiling import timeit

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def emit(kind: str, **kw) -> None:
    print(json.dumps({"kind": kind, **kw}), flush=True)


def production_batch(batch: int = 8, seed: int = 0):
    """Frames [B, 150, 256, 340, 3] of textured motion on the device, the
    production plan arrays and a random bf16 6-member TSN."""
    from videoquery.nn.tsn import TwoStreamTSN
    from videoquery.pipeline.sampling import (flow_pair_plan, flow_warm_plan,
                                              frame_ticks)
    from videoquery.testing.synthetic import textured_motion_clips

    rng = np.random.default_rng(seed)
    frames = jax.device_put(textured_motion_clips(batch, 150, 256, 340, rng))
    pair_idx, stack_pos = flow_pair_plan(150, 25, 5)
    warm = tuple(jnp.asarray(a) for a in flow_warm_plan(pair_idx, 3))
    plan = dict(ticks=jnp.asarray(frame_ticks(150, 25, 1) - 1, jnp.int32),
                stack=jnp.asarray(stack_pos, jnp.int32),
                pairs=jnp.asarray(pair_idx, jnp.int32), warm=warm)
    tsn = TwoStreamTSN.random(jax.random.PRNGKey(seed), splits=(1, 2, 3),
                              dtype=jnp.bfloat16)
    return frames, plan, tsn


def measure_levels(frames, plan, reps):
    from videoquery.kernels.tvl1 import _pyramid_shapes, _tvl1_level
    from videoquery.pipeline.extract import (PRODUCTION_TVL1,
                                             _flow_gray_grid,
                                             warm_tvl1_params)

    gray, _ = jax.jit(_flow_gray_grid, static_argnums=(1,))(frames, 2)
    b = gray.shape[0]
    key_pairs = plan["pairs"][plan["warm"][0]]
    warm_pairs = plan["pairs"][plan["warm"][1]]
    p = PRODUCTION_TVL1
    total = 0.0
    for name, pairs, params, levels in (
            ("key", key_pairs, p, range(p.n_scales)),
            ("warm", warm_pairs, warm_tvl1_params(p), range(1))):
        i0 = jnp.take(gray, pairs, axis=1).reshape((-1,) + gray.shape[2:])
        i1 = jnp.take(gray, pairs + 1, axis=1).reshape(i0.shape)
        shapes = _pyramid_shapes(*i0.shape[1:], params)
        for lvl in levels:
            hw = shapes[lvl]
            a = jax.image.resize(i0, (i0.shape[0],) + hw, "linear")
            c = jax.image.resize(i1, a.shape, "linear")
            z = jnp.zeros_like(a)
            pl = params.at_level(lvl)
            fn = jax.jit(jax.vmap(lambda x, y, u, v, pl=pl: _tvl1_level(
                x, y, u, v, pl)))
            t, _ = timeit(fn, a, c, z, z, reps=reps)
            total += t
            emit("level", pairs=name, level=lvl, hw=list(hw),
                 n_pairs=int(a.shape[0]), warps=pl.n_warps,
                 iters=pl.n_iters, ms=t * 1e3,
                 us_per_pair_iter=t * 1e6 / (a.shape[0] * pl.n_warps
                                             * pl.n_iters))
    emit("level_total", batch_clips=b, ms=total * 1e3)


def measure_stem(reps):
    from videoquery.nn import bn_inception
    from videoquery.nn.tsn import TwoStreamTSN
    from videoquery.pipeline.extract import _ensemble_embed

    tsn = TwoStreamTSN.random(jax.random.PRNGKey(0), splits=(1, 2, 3),
                              dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    x_rgb = jnp.asarray(rng.normal(size=(200, 224, 224, 3)), jnp.bfloat16)
    x_flow = jnp.asarray(rng.normal(size=(200, 224, 224, 10)), jnp.bfloat16)
    s2d = bn_inception._stem_s2d

    def plain(params, x):
        return bn_inception._conv(params, "conv1/7x7_s2", x, 7, 3, 2)

    def forward(stem):
        bn_inception._stem_s2d = stem  # read when the forward is traced
        f = jax.jit(lambda pr, pf, xr, xf: (_ensemble_embed(pr, xr),
                                            _ensemble_embed(pf, xf)))
        args = (tsn.rgb.stacked_params, tsn.flow.stacked_params, x_rgb,
                x_flow)
        out = jax.block_until_ready(f(*args))
        return f, args, out

    fns = {}
    try:
        for name, stem in (("s2d", s2d), ("plain", plain)):
            fns[name] = forward(stem)
    finally:
        bn_inception._stem_s2d = s2d
    a = np.asarray(jnp.concatenate(fns["s2d"][2]), np.float64)
    b = np.asarray(jnp.concatenate(fns["plain"][2]), np.float64)
    emit("stem_agreement", max_rel_l2=float(
        (np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max()))
    for name in ("s2d", "plain", "plain", "s2d"):
        f, args, _ = fns[name]
        t, _ = timeit(f, *args, reps=reps)
        emit("stem", stem=name, ensemble_ms=t * 1e3)


def measure_query(reps):
    from videoquery.search.distributed import _local_query

    n, q = 1_000_000, 16
    feats = jax.jit(lambda: (jax.random.normal(
        jax.random.PRNGKey(0), (6, n, 1024), jnp.float32) * 0.03
    ).astype(jnp.bfloat16).reshape(2, 3, n, 1024))()
    mask = jnp.ones((2, 3, n), bool)
    t = jax.random.normal(jax.random.PRNGKey(1), (q, 2, 3, 1024)) * 0.03
    tm = jnp.ones((q, 2, 3), bool)
    w = jnp.ones((q, 2), jnp.float32).at[:, 1].set(1.5)
    fn = jax.jit(lambda *a: _local_query(*a, k=20))
    times = []
    for _ in range(reps):
        jax.block_until_ready(fn(feats, mask, t, tm, w))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(feats, mask, t, tm, w))
        times.append(time.perf_counter() - t0)
    floor = feats.nbytes / HBM_BYTES_PER_S
    p50 = float(np.median(times))
    emit("query", q=q, segments=n, index_gb=feats.nbytes / 1e9,
         p50_ms=p50 * 1e3, floor_ms=floor * 1e3, ratio=p50 / floor)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+",
                    default=["level", "stem", "query"])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    from videoquery.core.jaxsetup import setup_jax

    setup_jax()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    emit("device", device_kind=dev.device_kind, card=card)
    if "level" in args.only:
        frames, plan, _tsn = production_batch()
        measure_levels(frames, plan, args.reps)
        del frames, _tsn
    if "stem" in args.only:
        measure_stem(args.reps)
    if "query" in args.only:
        measure_query(args.reps)


if __name__ == "__main__":
    main()
