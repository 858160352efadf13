"""Benchmark harness — runs on one NVIDIA GPU and refuses any other device.

Measures:
  1. two-stream feature extraction throughput (clips/s): the fused
     gray -> warped TV-L1 -> tick-sample -> preprocess -> 6-member TSN
     program at the production schedule;
  2. end to end: video file -> feature CSVs;
  3. batched query latency (p50) over a 1M-segment index;
  4. revise-round latency (100k and 1M segments);
  5. CSV ingest rate.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": null,
   "device": {...}, "metrics": {...}}
Extra stage timings go to stderr. Every timing waits for the device with
jax.block_until_ready.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info() -> dict:
    """The device the numbers come from; exits nonzero on anything but a
    GPU (a CPU run of this harness measures nothing anyone deploys)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def bench_extraction(n_batches: int = 8, batch_clips: int = 8,
                     frames_per_clip: int = 150, hw=(256, 340),
                     num_ticks: int = 25, splits=(1, 2, 3),
                     flow_res_div: int = 2, flow_warm_group: int | None = None,
                     warm_iters: int | None = None,
                     tvl1_kw: dict | None = None,
                     frames_kind: str = "textured",
                     dtype: str = "bfloat16") -> float:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from videoquery.nn.tsn import TwoStreamTSN
    from videoquery.pipeline.extract import PRODUCTION_TVL1, _extract_step
    from videoquery.pipeline.sampling import frame_ticks
    from videoquery.testing.synthetic import textured_motion_clips

    h, w = hw
    log(f"[extract] building TSN ensemble (splits={splits}, dtype={dtype})")
    tsn = TwoStreamTSN.random(jax.random.PRNGKey(0), splits=splits, dtype=jnp.dtype(dtype))
    # Bench exactly what ships: the production schedule (incl. warm_iters /
    # coarse_hw), with an explicit override only for sweeps.
    tvl1 = PRODUCTION_TVL1
    if warm_iters is not None:
        tvl1 = dataclasses.replace(tvl1, warm_iters=warm_iters)
    if tvl1_kw:
        tvl1 = dataclasses.replace(tvl1, **tvl1_kw)

    rng = np.random.default_rng(0)
    bh = h // flow_res_div * flow_res_div
    bw = w // flow_res_div * flow_res_div
    if frames_kind == "textured":
        frames_np = textured_motion_clips(batch_clips, frames_per_clip,
                                          bh, bw, rng)
    else:
        frames_np = rng.integers(
            0, 255, (batch_clips, frames_per_clip, bh, bw, 3), np.uint8)
    frames = jax.device_put(jnp.asarray(frames_np))
    from videoquery.pipeline.sampling import flow_pair_plan

    ticks = frame_ticks(frames_per_clip, num_ticks, 1) - 1
    pair_idx, stack_pos = flow_pair_plan(frames_per_clip, num_ticks, 5)
    ticks_j = jnp.asarray(ticks, jnp.int32)
    sidx_j = jnp.asarray(stack_pos, jnp.int32)
    pair_j = jnp.asarray(pair_idx, jnp.int32)

    from videoquery.core.config import ExtractionConfig

    if flow_warm_group is None:
        flow_warm_group = ExtractionConfig().flow_warm_group
    warm_camera = ExtractionConfig().flow_warm_camera
    warm = None
    if flow_warm_group > 1:
        from videoquery.pipeline.sampling import flow_warm_plan

        kp, wp, ws = flow_warm_plan(pair_idx, flow_warm_group)
        if wp.size:
            warm = (jnp.asarray(kp), jnp.asarray(wp), jnp.asarray(ws))
    log(f"[extract] tvl1 s{tvl1.n_scales} w{tvl1.n_warps} "
        f"i{tvl1.n_iters} fi{tvl1.fine_iters} wi{tvl1.warm_iters}, "
        f"flow res 1/{flow_res_div}, warm group "
        f"{flow_warm_group} cam={warm_camera}")

    def step():
        return _extract_step(
            tsn.rgb.stacked_params, tsn.flow.stacked_params, frames,
            ticks_j, sidx_j, 20.0, True, tvl1, (340, 256), 224, dtype, pair_j,
            flow_res_div,
            flow_warm_plan=warm,
            flow_warm_camera=warm_camera,
        )

    sync = jax.block_until_ready

    log("[extract] compiling fused extraction step...")
    t0 = time.time()
    sync([step()])
    log(f"[extract] compile+first run: {time.time()-t0:.1f}s")

    # Production timing model: extract_video_stream queues batches with
    # DEFERRED readback (ClipSignatures keeps device arrays; one download at
    # the end), so the per-batch device time queues all batches
    # asynchronously and waits once.
    t0 = time.time()
    sync([step() for _ in range(n_batches)])
    dt = time.time() - t0
    clips = n_batches * batch_clips
    rate = clips / dt
    log(f"[extract] {clips} clips in {dt:.2f}s -> {rate:.2f} clips/s "
        f"({rate * frames_per_clip:.0f} fps equivalent)")
    return rate


def bench_e2e(n_frames: int = 1204, hw=(340, 256), batch_clips: int = 8,
              splits=(1, 2, 3), host_gray: bool = True,
              host_crop: bool = True, host_yuv420: bool = True,
              sustained_frames: int = 3604
              ) -> tuple[float, float, float]:
    """The honest production number: video FILE -> feature CSVs, wall clock
    including host decode (the headline extract mode feeds in-memory
    frames). Decode overlaps device compute via Extractor.extract_video_
    stream. The host producer (decode at target scale + cv2 gray) sets a
    per-core ceiling, reported beside the device-overlapped rates.

    Reports TWO rates: the n_frames video is ONE device batch (a fully
    serialized decode -> upload -> compute -> readback chain, the
    worst-case short-video latency), while the sustained_frames video spans
    several batches so the stream path overlaps decode/upload with device
    compute — the number a production backlog of long videos sees."""
    import tempfile

    import jax

    from videoquery.core.config import ExtractionConfig
    from videoquery.nn.tsn import TwoStreamTSN
    from videoquery.pipeline import decode
    from videoquery.pipeline.extract import Extractor

    tmp = tempfile.mkdtemp(prefix="vq_e2e_")
    video = os.path.join(tmp, "bench.mp4")
    log(f"[e2e] synthesizing {n_frames}-frame {hw[0]}x{hw[1]} mp4...")
    decode.synthesize_video(video, n_frames=n_frames, size=hw)

    # Host ceiling: the STREAMING PRODUCER's own rate — decode at target
    # scale plus (in host_gray mode) the per-frame cv2 gray at the flow
    # grid. This is what extract_video_stream actually overlaps device work
    # against; timing load_video's whole-video materialization instead
    # under-reported the ceiling ~16x (np.stack of 300+ MB plus cgroup
    # burst throttling dominate that number, not decode — the raw decode
    # generator runs thousands of fps at this codec/size). Best of 2
    # passes: the first may pay page-cache warmup.
    from videoquery.pipeline.extract import flow_grid_shape

    cfg_probe = ExtractionConfig()
    fh, fw = flow_grid_shape(hw[1], hw[0], cfg_probe.flow_res_div)
    producer_fps = 0.0
    for _ in range(2):
        t0 = time.time()
        n_dec = 0
        for f in decode.video_frames(video, hw):
            if host_gray:
                decode.gray_flow_grid(f[None], fh, fw)
            n_dec += 1
        producer_fps = max(producer_fps, n_dec / (time.time() - t0))
    decode_rate = producer_fps / 150.0
    log(f"[e2e] host producer ceiling (decode at target scale"
        f"{' + gray' if host_gray else ''}): {producer_fps:.0f} fps/core = "
        f"{decode_rate:.1f} clips/s")

    # FULL producer ceiling: decode + gray + payload build (crop, yuv420,
    # concat) — everything the one host core must do per clip besides the
    # grpc upload itself. The gap between this and sustained is the
    # upload-serialization + dispatch share of the same core.
    cfg_full = ExtractionConfig(batch_clips=batch_clips,
                                host_gray=host_gray, host_crop=host_crop,
                                host_yuv420=host_crop and host_yuv420)
    from videoquery.pipeline.payload import stream_payloads as _sp

    full_rate = 0.0
    for _ in range(2):
        t0 = time.time()
        n_p = sum(len(pl.nums)
                  for pl in _sp(video, cfg_full, cfg_full.flow_res_div, None))
        full_rate = max(full_rate, n_p / (time.time() - t0))
    log(f"[e2e] full producer ceiling (+payload build): "
        f"{full_rate:.1f} clips/s/core")

    log(f"[e2e] building TSN ensemble (splits={splits})")
    tsn = TwoStreamTSN.random(jax.random.PRNGKey(0), splits=splits,
                              dtype=jax.numpy.bfloat16)
    hc = host_gray and host_crop
    ex = Extractor(tsn, ExtractionConfig(batch_clips=batch_clips,
                                         host_gray=host_gray,
                                         host_crop=hc,
                                         host_yuv420=hc and host_yuv420),
                   dtype="bfloat16")
    # warm the compile caches off the clock (same geometry as the real run)
    warm = ex.extract_video_stream(video)
    n_clips = sum(len(s.clip_numbers) for s in warm)

    t0 = time.time()
    sigs = ex.extract_video_stream(video)
    ex.write_csv_tree(sigs, tmp, "bench", video)
    dt = time.time() - t0
    rate = n_clips / dt
    log(f"[e2e] video file -> CSVs: {n_clips} clips in {dt:.2f}s = "
        f"{rate:.2f} clips/s (decode-overlapped, 1 batch)")

    sustained = 0.0
    mp_sustained = 0.0
    mp_producer = 0.0
    mp_cold = 0.0
    payload_mb = 0.0
    if sustained_frames:
        long_video = os.path.join(tmp, "bench_long.mp4")
        decode.synthesize_video(long_video, n_frames=sustained_frames,
                                size=hw)
        t0 = time.time()
        sigs = ex.extract_video_stream(long_video)
        ex.write_csv_tree(sigs, tmp, "bench_long", long_video)
        dt = time.time() - t0
        n_long = sum(len(s.clip_numbers) for s in sigs)
        sustained = n_long / dt
        log(f"[e2e] sustained ({n_long} clips, "
            f"{(n_long + batch_clips - 1)//batch_clips} batches): {dt:.2f}s "
            f"= {sustained:.2f} clips/s")

        # bytes per clip actually shipped at these settings
        from videoquery.pipeline.payload import stream_payloads

        pl = next(iter(stream_payloads(long_video, ex.cfg, ex.flow_res_div,
                                       ex._decode_size())))
        payload_mb = sum(
            a.nbytes for a in (pl.clip_rgb, pl.gray) if a is not None
        ) / len(pl.nums) / 1e6
        log(f"[e2e] payload: {payload_mb:.2f} MB/clip shipped")

        # multi-process producer (pipeline/mpstream.py): 2 decode workers
        # over 2 distinct videos feeding the one dispatcher. (a) aggregate
        # PRODUCER ceiling — scales with cores on multi-core hosts; on a
        # 1-core host it measures the honest non-scaling. (b) sustained
        # e2e through the device.
        long2 = os.path.join(tmp, "bench_long2.mp4")
        decode.synthesize_video(long2, n_frames=sustained_frames, size=hw)
        import multiprocessing as mp_mod

        ctx = mp_mod.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_mp_producer_rate,
                             args=(p, hw, host_gray, fh, fw, q))
                 for p in (long_video, long2)]
        from videoquery.pipeline.mpstream import start_off_device

        start_off_device(procs)  # probes must never open the card
        # per-worker (frames, seconds) measured INSIDE the worker around
        # its decode loop only — spawn startup is a fixed cost production
        # amortizes, not part of the steady-state ceiling
        rates = [q.get() for _ in procs]
        for p in procs:
            p.join()
        mp_fps = sum(n / dt_ for n, dt_ in rates)
        mp_producer = mp_fps / 150.0
        log(f"[e2e] mp producer ceiling (2 workers, 2 videos, in-worker "
            f"steady-state): {mp_fps:.0f} fps aggregate = "
            f"{mp_producer:.1f} clips/s "
            f"(1-worker ceiling {decode_rate:.1f}; "
            f"{os.cpu_count()} host cores)")

        # persistent pool: spawn cost is paid ONCE (first call, "cold");
        # the second call measures steady state — the number a production
        # fleet runs at (pool reuse across calls, mpstream.WorkerPool)
        from videoquery.pipeline.mpstream import WorkerPool, extract_videos_mp

        with WorkerPool(2, ex.cfg, ex.flow_res_div,
                        ex._decode_size()) as pool:
            t0 = time.time()
            by_path = extract_videos_mp(ex, [long_video, long2], pool=pool)
            dt_cold = time.time() - t0
            n_mp = sum(len(s.clip_numbers) for sg in by_path.values()
                       for s in sg)
            t0 = time.time()
            by_path = extract_videos_mp(ex, [long_video, long2], pool=pool)
            dt = time.time() - t0
        mp_cold = n_mp / dt_cold
        mp_sustained = n_mp / dt
        log(f"[e2e] mp sustained (2 workers, warm pool, {n_mp} clips): "
            f"{dt:.2f}s = {mp_sustained:.2f} clips/s "
            f"(cold incl. spawn: {mp_cold:.2f} clips/s; "
            f"single-process sustained {sustained:.2f})")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {
        "rate": rate, "decode_rate": decode_rate,
        "full_producer_rate": full_rate, "sustained": sustained,
        "mp_sustained": mp_sustained, "mp_producer": mp_producer,
        "mp_cold": mp_cold, "payload_mb": payload_mb,
    }


def _mp_producer_rate(path, hw, host_gray, fh, fw, q):
    """Decode-worker body for the mp producer-ceiling measurement
    (module-level: spawn targets must pickle)."""
    import time as _t

    from videoquery.pipeline import decode as _dec

    t0 = _t.time()
    n = 0
    for f in _dec.video_frames(path, hw):
        if host_gray:
            _dec.gray_flow_grid(f[None], fh, fw)
        n += 1
    q.put((n, _t.time() - t0))


def bench_query(n_segments: int = 1_000_000, dim: int = 1024, q: int = 16,
                k: int = 20, splits: int = 3, streams: int = 2,
                dtype: str = "bfloat16", repeats: int = 20) -> float:
    import jax
    import jax.numpy as jnp

    from videoquery.search.distributed import _local_query

    log(f"[query] building {n_segments}-segment index "
        f"({streams}x{splits}x{n_segments}x{dim} {dtype})")
    # generate the index ON DEVICE (uploading 12 GB is not the thing being
    # measured; threefry-generating 6.4B normals isn't either — a
    # deterministic varied fill is enough for timing)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)

    @jax.jit
    def make_index():
        dt = jnp.dtype(dtype)
        base = jax.random.normal(keys[0], (7, dim), jnp.float32).astype(dt)
        rows = jax.lax.broadcasted_iota(jnp.int32, (streams, splits, n_segments), 2)
        scale = (1.0 + (rows % 1013).astype(dt)[..., None] * dt.type(1e-3))
        feats = base[rows % 7] * scale  # stays in `dt`: no f32 temp at 2x size
        mask = jnp.ones((streams, splits, n_segments), bool)
        return feats, mask

    feats, mask = jax.block_until_ready(make_index())

    targets = jax.random.normal(keys[1], (q, streams, splits, dim), jnp.float32)
    tmask = jnp.ones((q, streams, splits), bool)
    weights = jnp.ones((q, streams), jnp.float32).at[:, 1].set(1.5)

    fn = jax.jit(lambda f_, m_, t_, tm_, w_: _local_query(f_, m_, t_, tm_, w_, k=k))
    t0 = time.time()
    jax.block_until_ready(fn(feats, mask, targets, tmask, weights))
    log(f"[query] compile+first: {time.time()-t0:.1f}s")

    times = []
    for _ in range(repeats):
        t0 = time.time()
        jax.block_until_ready(fn(feats, mask, targets, tmask, weights))
        times.append(time.time() - t0)
    p50 = float(np.median(times)) * 1000
    per_query = p50 / q
    log(f"[query] batch of {q} queries over {n_segments} segments: "
        f"p50 {p50:.1f} ms/batch = {per_query:.2f} ms/query (target <100 ms)")
    return p50


def bench_ingest(n_videos: int = 50, clips_per_video: int = 100,
                 dim: int = 1024) -> tuple[float, float]:
    """BASELINE config 3: UCF101-scale CSV ingest. Generates a synthetic
    feature-CSV tree (6 CSVs per video: 2 streams x 3 splits) and measures
    end-to-end parse+index build (native C++ parser when available)."""
    import shutil
    import tempfile

    from videoquery.index.csvio import write_features_csv
    from videoquery.service.loader import load_index

    rng = np.random.default_rng(0)
    root = tempfile.mkdtemp(prefix="vq_ingest_")
    try:
        log(f"[ingest] generating {n_videos} videos x {clips_per_video} clips "
            f"x 6 CSVs ({n_videos*clips_per_video*6} rows of {dim}-d)")
        for vi in range(n_videos):
            vecs = rng.normal(size=(clips_per_video, dim))
            for split in (1, 2, 3):
                d = os.path.join(root, f"vid{vi:03d}", f"UCF101_split{split}")
                os.makedirs(d)
                for stream in ("rgb", "warped_optical_flow"):
                    write_features_csv(
                        os.path.join(d, f"{stream}_global_pool_features.csv"),
                        f"vid{vi:03d}", "u/", stream, "global_pool", "m",
                        [(i + 1, vecs[i]) for i in range(clips_per_video)],
                    )
        rows = n_videos * clips_per_video * 6
        # parse-only rate first: the CSV decode itself (native Eisel-Lemire
        # parser), separated from index assembly + host->device transfer
        from videoquery.index.csvio import list_feature_tree, read_features_csv

        t0 = time.time()
        for _, _, csv_path in list_feature_tree(root):
            read_features_csv(csv_path)
        parse_dt = time.time() - t0
        log(f"[ingest] parse-only: {rows} rows in {parse_dt:.1f}s "
            f"({rows/parse_dt:.0f} rows/s)")

        t0 = time.time()
        index = load_index(root, feature_dim=dim)
        dt = time.time() - t0
        log(f"[ingest] {rows} rows -> {index.n_clips} clips in {dt:.1f}s "
            f"({rows/dt:.0f} rows/s incl. index build + device transfer)")
        return rows / dt, rows / parse_dt
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_round(n_segments: int = 100_000, n_reviewed: int = 20,
                repeats: int = 5, dtype: str = "float32",
                resident: bool | None = None, q: int = 1) -> float:
    """Full revise round(s) (BASELINE configs 4-5): similarity over the
    search set + 40x30 grid optimization + rescoring + seeded selection.
    The reference does this as Python loops (~40 rescoring passes over every
    clip per round, SURVEY.md §3.1 hot loops) and serves ONE job per 5 s
    poll (api_repository.py:53-63).

    q > 1 measures the batched serving path (BASELINE config 5 'broker at
    scale'): Q concurrent revise rounds whose similarity pass is ONE device
    program over the shared resident index (the index is read from memory once
    for all Q queries — service/compute_matches.py groups a poll's jobs
    exactly like this). Returns p50 ms for the whole Q-batch.

    resident=None picks what process_job picks: the device-resident banded
    round (engine.ResidentTable) at/above SearchConfig.big_round_threshold,
    the one-shot full-table download below. dtype="bfloat16" halves index
    memory (12.3 GB at 1M segments) — the similarity einsum still
    accumulates f32."""
    import random as pyrandom

    import jax
    import jax.numpy as jnp

    from videoquery.core.config import HyperParams, SearchConfig
    from videoquery.index.store import FeatureIndex
    from videoquery.search.engine import SearchEngine
    from videoquery.search.selection import select_clips_to_review

    rng = np.random.default_rng(0)
    hp = HyperParams()
    streams, splits, d = hp.streams, (1, 2, 3), 1024
    if resident is None:
        resident = n_segments >= SearchConfig().big_round_threshold

    log(f"[round] building {n_segments}-segment search set on device "
        f"({dtype}, {'resident banded' if resident else 'full download'} "
        f"round)")
    dt = jnp.dtype(dtype)
    idx_feats = jax.jit(lambda: (jax.random.normal(
        jax.random.PRNGKey(0), (2, 3, n_segments, d), jnp.float32) * 0.03
    ).astype(dt))()
    index = FeatureIndex.__new__(FeatureIndex)
    index.clip_ids = np.arange(1, n_segments + 1, dtype=np.int64)
    index.feats = idx_feats
    index.mask = jnp.ones((2, 3, n_segments), bool)
    index.streams = tuple(streams)
    index.splits = splits
    index.feature_name = hp.feature_name
    index._id_to_pos = None  # positions == id-1 for this bench
    index.position = lambda cid: int(cid) - 1
    index.host_feats = None
    index.host_mask = None

    targets = [
        {s: {k: (rng.normal(size=d) * 0.03).tolist() for k in splits}
         for s in streams}
        for _ in range(q)
    ]
    engine = SearchEngine(index)
    qlabels = []
    for _ in range(q):
        reviewed_ids = rng.choice(n_segments, n_reviewed, replace=False) + 1
        qlabels.append(
            {int(c): float(rng.integers(0, 2)) for c in reviewed_ids})

    def select(scores, hp_round):
        return select_clips_to_review(scores, {}, 1, hp_round.threshold, 20,
                                      hp.near_miss_default,
                                      rng=pyrandom.Random(42))

    def one_round():
        tables = engine.compute_similarities_multi(targets, resident=resident)
        if resident and q > 1:
            # the broker's group-batched finish (compute_matches.
            # _prepare_group_rounds): ONE gather + ONE banded program for
            # the whole group instead of two downloads per query
            from videoquery.search.engine import (optimize_many,
                                                  round_scores_many)

            hps = [h for h, _ in optimize_many(tables, qlabels, hp)]
            specs = [{"weights": h.weights, "threshold": h.threshold,
                      "near_miss": hp.near_miss_default, "keep_ids": [1],
                      "user_match_ids": [], "finalize": False}
                     for h in hps]
            scores_list = round_scores_many(tables, specs)
            return [
                select(sc if sc is not None
                       else tbl.to_table().scores(h.weights), h)
                for tbl, h, sc in zip(tables, hps, scores_list)
            ]
        out = []
        for tbl, labels in zip(tables, qlabels):
            hp_round, _ = tbl.optimize(labels, hp)
            if resident:
                scores = tbl.round_scores(hp_round.weights,
                                          hp_round.threshold,
                                          hp.near_miss_default, keep_ids=[1])
                if scores is None:  # band overflow: full-table fallback
                    scores = tbl.to_table().scores(hp_round.weights)
            else:
                scores = tbl.scores(hp_round.weights)
            out.append(select(scores, hp_round))
        return out

    one_round()  # compile
    times = []
    for _ in range(repeats):
        t0 = time.time()
        matches = one_round()
        times.append(time.time() - t0)
    p50 = float(np.median(times)) * 1000
    if q == 1:
        log(f"[round] full revise round over {n_segments} segments: "
            f"p50 {p50:.0f} ms ({len(matches[0])} matches selected)")
    else:
        log(f"[round] {q} concurrent revise rounds over {n_segments} "
            f"segments (one similarity program): p50 {p50:.0f} ms total "
            f"= {p50 / q:.1f} ms/query")
    return p50


def main():
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from videoquery.core.jaxsetup import setup_jax

    setup_jax()  # persistent compile cache: repeat runs skip compiles
    device = device_info()
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="all",
                    choices=["extract", "query", "round", "ingest", "both",
                             "e2e", "all"])
    ap.add_argument("--segments", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=8,
                    help="device batches per timing window (more batches "
                         "amortize the single final wait better; same "
                         "steady-state quantity)")
    ap.add_argument("--batch_clips", type=int, default=8)
    ap.add_argument("--warm_iters", type=int, default=None,
                    help="override TVL1Params.warm_iters for sweep runs "
                         "(default: production value)")
    ap.add_argument("--host_gray", dest="host_gray", action="store_true",
                    default=True,
                    help="e2e mode: compact upload (host cv2 gray + tick "
                         "frames only; ExtractionConfig.host_gray). Default "
                         "ON; the gate passed at both corpus scales "
                         "(tools/flow_quality.py --host_gray)")
    ap.add_argument("--device_gray", dest="host_gray", action="store_false",
                    help="e2e mode: full-frame upload + on-device gray")
    ap.add_argument("--no_host_crop", dest="host_crop", action="store_false",
                    default=True,
                    help="e2e mode: disable host-side tick-frame resize+crop "
                         "(ExtractionConfig.host_crop; on by default — pure "
                         "slicing at decode_at_target scale, bit-identical "
                         "embeddings, ~42%% fewer rgb upload bytes)")
    ap.add_argument("--no_host_yuv420", dest="host_yuv420",
                    action="store_false", default=True,
                    help="e2e mode: disable the YUV 4:2:0 tick upload "
                         "(ExtractionConfig.host_yuv420; on by default — "
                         "1.5 B/px instead of 3; "
                         "the reference's own rgb inputs went through 4:2:0 "
                         "JPEGs, so this applies strictly less chroma loss)")
    args = ap.parse_args()

    # One JSON line; `metrics` carries every named number (separate fields,
    # not numbers stuffed into the metric name), `device` names the card.
    metrics: dict[str, float] = {}

    def emit(metric, value, unit, vs):
        print(json.dumps({
            "metric": metric,
            "value": value,
            "unit": unit,
            "vs_baseline": vs,
            "device": device,
            "metrics": metrics,
        }))

    def free_device_memory():
        import gc

        import jax

        gc.collect()
        jax.clear_caches()
        gc.collect()

    rate = None
    p50 = None
    if args.mode in ("extract", "both", "all"):
        rate = bench_extraction(n_batches=args.batches,
                                batch_clips=args.batch_clips,
                                warm_iters=args.warm_iters)
        metrics["extraction_device_clips_per_s"] = round(rate, 3)
        # worst case: uniform noise defeats warm starts (same compiled
        # program)
        noise = bench_extraction(n_batches=args.batches,
                                 batch_clips=args.batch_clips,
                                 warm_iters=args.warm_iters,
                                 frames_kind="noise")
        metrics["extraction_noise_worstcase_clips_per_s"] = round(noise, 3)
    if args.mode in ("e2e", "all"):
        r = bench_e2e(
                batch_clips=args.batch_clips, host_gray=args.host_gray,
                host_crop=args.host_crop, host_yuv420=args.host_yuv420)
        e2e_rate = r["rate"]
        metrics["e2e_file_to_csvs_clips_per_s"] = round(e2e_rate, 3)
        metrics["e2e_sustained_clips_per_s"] = round(r["sustained"], 3)
        metrics["host_producer_clips_per_s_ceiling"] = \
            round(r["decode_rate"], 3)
        metrics["e2e_full_producer_clips_per_s_core"] = \
            round(r["full_producer_rate"], 3)
        metrics["mp_producer_clips_per_s_2workers"] = \
            round(r["mp_producer"], 3)
        metrics["e2e_mp_sustained_clips_per_s_2workers"] = \
            round(r["mp_sustained"], 3)
        metrics["e2e_mp_cold_clips_per_s_2workers"] = round(r["mp_cold"], 3)
        metrics["e2e_payload_mb_per_clip"] = round(r["payload_mb"], 3)
        if args.mode == "e2e":
            return emit("e2e_video_file_to_csvs_throughput",
                        round(e2e_rate, 3), "clips/s", None)
    if args.mode in ("query", "both", "all"):
        if rate is not None:
            # free the extraction working set before building the 12.3 GB
            # index
            free_device_memory()
        p50 = bench_query(n_segments=args.segments)
        metrics["query_p50_ms_batch16_%dk_segments" % (args.segments // 1000)] \
            = round(p50, 2)
        metrics["query_p50_ms_per_query"] = round(p50 / 16, 3)
    if args.mode in ("round", "all"):
        if args.mode == "all":
            free_device_memory()
        r50 = bench_round()
        metrics["revise_round_p50_ms_100k_segments"] = round(r50, 1)
        # the big-corpus flavor: 1M segments, bf16 index (12.3 GB),
        # device-resident banded round — only candidates cross the wire
        free_device_memory()
        r50_big = bench_round(n_segments=1_000_000, dtype="bfloat16",
                              resident=True)
        metrics["revise_round_p50_ms_1m_segments_resident"] = round(r50_big, 1)
        # BASELINE config 5: Q concurrent revise rounds batched into one
        # similarity program over the shared resident index (the broker's
        # drained-poll serving path) — sub-linear in Q vs Q sequential rounds
        free_device_memory()
        r50_q8 = bench_round(n_segments=1_000_000, dtype="bfloat16",
                             resident=True, q=8)
        metrics["concurrent8_rounds_p50_ms_1m_segments"] = round(r50_q8, 1)
        metrics["concurrent8_rounds_ms_per_query"] = round(r50_q8 / 8, 1)
        metrics["concurrent8_vs_sequential_speedup"] = round(
            8 * r50_big / r50_q8, 2)
        if args.mode == "round":
            return emit("revise_round_p50_over_100k_segments",
                        round(r50, 1), "ms", None)
    if args.mode in ("ingest", "all"):
        rows_per_s, parse_rows_per_s = bench_ingest()
        metrics["ingest_csv_rows_per_s"] = round(rows_per_s, 1)
        metrics["ingest_parse_only_rows_per_s"] = round(parse_rows_per_s, 1)
        if args.mode == "ingest":
            return emit("csv_ingest_rows_per_sec", round(rows_per_s, 1),
                        "rows/s", None)

    if rate is not None:
        emit("two_stream_extraction_throughput", round(rate, 3),
             "clips/s", None)
    else:
        emit("query_p50_over_%d_segments" % args.segments, round(p50, 2),
             "ms", None)


if __name__ == "__main__":
    main()
