#!/usr/bin/env python3
"""Smoke test of the whole system on one NVIDIA GPU (or, with --chips 4,
of its multi-card paths on four).

One card (no arguments), phases in order:
  1. device   — JAX must find a GPU; there is no CPU fallback.
  2. extract  — Extractor.extract_frames at the production configuration
                (ExtractionConfig() defaults, PRODUCTION_TVL1 with its
                homography camera, warm start + "init" warm camera, the full
                6-member TSN with random weights from --seed, bf16) on 16
                clips of seeded textured-motion video at 340x256, then
                write_csv_tree.
  3. parity   — each path against its plain reference on the CPU device of
                the same process: one clip's quantized flow, its [6, 1024]
                signatures in f32 under "highest" precision and at the
                shipped bf16 settings.
  4. serve    — the in-repo fake Video Query API on a local socket; the
                loader CLI ingests the phase-2 CSVs plus the vendored
                fixture corpora; the broker runs single-shot through a new
                round, a revise and a finalize; device top-k against the
                float64 exact engine on that search set.
  5. scale    — a 2x3x1M x1024 bf16 search set (12.3 GB) built on the card;
                16 queries through ShardedSearch; one revise round through
                the resident banded path; device top-k against float64 on a
                100k-segment slice.

--chips 4 runs only: ShardedSearch over a data=4 mesh at 1M segments
against the one-card top-k, ShardedSearch at 4M segments (12.3 GB per card)
answering 16 queries, and a 32-clip Extractor batch sharded over the four
cards against the one-card embeddings.

Every phase prints its wall time and the time JAX spent compiling in it.
Before the last line the card's name and power limit are printed as
nvidia-smi reports them; the last line is one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failure exits nonzero without that line.

Run: python chip_smoke.py [--seed 0] [--chips 4]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the device-vs-reference comparisons (also in PERF.md).
FLOW_WITHIN_ONE_STEP = 0.99   # share of flow pixels within 1 u8 step
EMB_F32_REL = 1e-4            # f32 "highest": max relative L2 per signature
EMB_SHIPPED_COS = 0.99        # bf16 shipped settings: min cosine per signature
# device scores must match float64 within this, and top-k order may differ
# only between scores closer than this: f32 sums of 1024 products err up to
# a few 1e-6 near a score of 1, TF32 products would err ~1e-3
SCORE_TIE = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(devices) -> str:
    """The contract's last line for a passing run on `devices`."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Full size is what runs on the card. `rehearsal` shrinks everything
    for a CPU dry run of the control flow (which never prints a result)."""

    videos: int = 2
    clips_per_video: int = 8
    hw: tuple[int, int] = (256, 340)   # decoded frame (H, W)
    segments: int = 1_000_000
    parity_segments: int = 100_000
    queries: int = 16

    @staticmethod
    def rehearsal() -> "Sizes":
        return Sizes(videos=2, clips_per_video=2, hw=(64, 80),
                     segments=4096, parity_segments=1024, queries=4)


class Phases:
    """Runs named phases, prints wall and compile time of each, and
    remembers failures (the run fails if any phase failed)."""

    def __init__(self):
        import jax

        self.failed: list[str] = []
        self._compile = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event.startswith("/jax/core/compile/") or \
                event.startswith("/jax/compilation_cache/"):
            self._compile += duration

    @contextlib.contextmanager
    def run(self, name: str):
        log(f"[{name}] start")
        t0, c0 = time.perf_counter(), self._compile
        try:
            yield
        except Exception:  # noqa: BLE001 — report, keep going, fail at end
            traceback.print_exc()
            self.failed.append(name)
            log(f"[{name}] FAILED")
        wall = time.perf_counter() - t0
        log(f"[{name}] wall {wall:.1f} s, compile {self._compile - c0:.1f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phase 2: extraction ------------------------------------------------------

def extraction_setup(seed: int, sizes: Sizes, rehearse: bool):
    import jax
    import jax.numpy as jnp

    from videoquery.core.config import ExtractionConfig
    from videoquery.kernels.tvl1 import TVL1Params
    from videoquery.nn.tsn import TwoStreamTSN
    from videoquery.pipeline.extract import PRODUCTION_TVL1

    if rehearse:
        cfg = ExtractionConfig(fps=5, clip_seconds=2, num_ticks=4,
                               frame_resize=(120, 96), crop_size=64,
                               batch_clips=2, min_tail_seconds=1)
        tvl1 = TVL1Params(n_scales=2, n_warps=2, n_iters=4, fine_iters=3,
                          warm_iters=2, camera_model="homography",
                          coarse_hw=(32, 40))
    else:
        cfg, tvl1 = ExtractionConfig(), PRODUCTION_TVL1
    tsn = TwoStreamTSN.random(jax.random.PRNGKey(seed), splits=(1, 2, 3),
                              dtype=jnp.bfloat16)
    return cfg, tvl1, tsn


def phase_extract(ctx: dict) -> None:
    from videoquery.pipeline.extract import Extractor, gather_signatures
    from videoquery.testing.synthetic import textured_motion_video

    sizes, cfg = ctx["sizes"], ctx["cfg"]
    ex = Extractor(ctx["tsn"], cfg, dtype="bfloat16", tvl1=ctx["tvl1"])
    rng = np.random.default_rng(ctx["seed"])
    n_frames = sizes.clips_per_video * cfg.frames_per_clip
    out = os.path.join(ctx["work"], "features")
    ctx["videos"] = {}
    for vi in range(sizes.videos):
        frames = textured_motion_video(n_frames, *sizes.hw, rng)
        t0 = time.perf_counter()
        sigs = gather_signatures(list(ex.extract_frames(frames)))
        dt = time.perf_counter() - t0
        n = sum(len(s.clip_numbers) for s in sigs)
        log(f"[extract] video {vi}: {n} clips in {dt:.2f} s "
            f"({n / dt:.2f} clips/s{', incl. compile' if vi == 0 else ''})")
        check(n == sizes.clips_per_video, f"expected {sizes.clips_per_video} "
              f"clips, got {n}")
        for s in sigs:
            check(s.rgb.shape == s.flow.shape == (3, len(s.clip_numbers), 1024),
                  f"signature shape {s.rgb.shape}")
            check(np.isfinite(s.rgb).all() and np.isfinite(s.flow).all(),
                  "non-finite signatures")
            check(float(np.abs(s.flow).sum()) > 0, "all-zero flow signatures")
        name = f"smoke_video{vi}"
        paths = ex.write_csv_tree(sigs, out, name, f"synthetic://{name}")
        check(len(paths) == 6, f"expected 6 CSVs, got {len(paths)}")
        ctx["videos"][name] = frames
    ex_plan = ex._plan_arrays(cfg.frames_per_clip)
    check(ex_plan[3] is not None and ex_plan[4] is not None,
          "extraction ran without the pair plan / warm start")
    log(f"[extract] pair plan: {len(np.asarray(ex_plan[3]))} of "
        f"{cfg.frames_per_clip - 1} pairs solved, "
        f"{len(np.asarray(ex_plan[4][0]))} keyframe pairs per clip")
    ctx["features"] = out


# -- phase 3: parity against the CPU reference --------------------------------

def phase_parity(ctx: dict) -> None:
    import jax
    import jax.numpy as jnp

    from videoquery.pipeline.extract import (_ensemble_embed, _flow_gray_grid,
                                             _pair_flow)
    from videoquery.pipeline.preprocess import (preprocess_flow,
                                                preprocess_rgb)
    from videoquery.pipeline.sampling import (flow_pair_plan, flow_warm_plan,
                                              frame_ticks)

    cfg, tvl1, tsn = ctx["cfg"], ctx["tvl1"], ctx["tsn"]
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    f = cfg.frames_per_clip
    clip = next(iter(ctx["videos"].values()))[:f][None]   # [1, F, H, W, 3]
    pair_idx, stack_pos = flow_pair_plan(f, cfg.num_ticks,
                                         cfg.flow_stack_depth)
    warm = tuple(np.asarray(a) for a in
                 flow_warm_plan(pair_idx, cfg.flow_warm_group))
    ticks = frame_ticks(f, cfg.num_ticks, 1) - 1

    # flow: identical f32 gray in, the same jitted program on each device
    gray, vscale = jax.jit(_flow_gray_grid, static_argnums=(1,),
                           static_argnames=("matmul",))(
        jax.device_put(clip, cpu), cfg.flow_res_div, matmul=False)
    flow_fn = jax.jit(_pair_flow, static_argnames=(
        "bound", "warped", "tvl1", "value_scale", "warm_camera"))
    fargs = (np.asarray(gray), pair_idx)
    fkw = dict(bound=cfg.flow_bound, warped=True, tvl1=tvl1,
               value_scale=tuple(float(v) for v in vscale),
               warm_plan=warm, warm_camera=cfg.flow_warm_camera)
    on = lambda dev, xs: jax.device_put(xs, dev)  # noqa: E731
    q_gpu = np.asarray(flow_fn(*on(gpu, fargs), **fkw))
    q_cpu = np.asarray(flow_fn(*on(cpu, fargs), **fkw))
    step = np.abs(q_gpu.astype(int) - q_cpu.astype(int))
    within = float((step <= 1).mean())
    log(f"[parity] flow u8 [{q_gpu.shape}]: {within:.5f} of values within "
        f"one step (bound {FLOW_WITHIN_ONE_STEP}), max step {step.max()}, "
        f"exactly equal {float((step == 0).mean()):.5f}")
    check(within >= FLOW_WITHIN_ONE_STEP, "flow parity")

    # embeddings: identical inputs (CPU flow stacks, rgb ticks) on each device
    d = cfg.flow_stack_depth
    stacks = q_cpu[:, stack_pos.reshape(-1)]
    t = len(ticks)
    h, w = stacks.shape[2:4]
    stacks = stacks.reshape(1, t, d, h, w, 2).transpose(0, 1, 3, 4, 2, 5)
    stacks = stacks.reshape(1, t, h, w, 2 * d)
    rgb_ticks = clip[:, ticks]

    def embed(rgb_p, flow_p, rgb_u8, stacks_u8, dtype):
        dt = jnp.dtype(dtype)
        r = preprocess_rgb(rgb_u8, cfg.frame_resize, cfg.crop_size, dtype=dt)
        fl = preprocess_flow(stacks_u8, cfg.frame_resize, cfg.crop_size,
                             dtype=dt)
        r = _ensemble_embed(rgb_p, r.reshape((-1,) + r.shape[2:]))
        fl = _ensemble_embed(flow_p, fl.reshape((-1,) + fl.shape[2:]))
        return jnp.concatenate([r.mean(axis=1), fl.mean(axis=1)])  # [6, D]

    embed_j = jax.jit(embed, static_argnames=("dtype",))
    f32 = lambda p: jax.tree.map(lambda a: a.astype(jnp.float32), p)  # noqa: E731
    inputs32 = (f32(tsn.rgb.stacked_params), f32(tsn.flow.stacked_params),
                rgb_ticks, stacks)
    ref = np.asarray(embed_j(*on(cpu, inputs32), dtype="float32"), np.float64)
    with jax.default_matmul_precision("highest"):
        hi = np.asarray(embed_j(*on(gpu, inputs32), dtype="float32"),
                        np.float64)
    rel = np.linalg.norm(hi - ref, axis=1) / np.linalg.norm(ref, axis=1)
    log(f"[parity] signatures f32 'highest' vs CPU: max relative L2 "
        f"{rel.max():.3e} (bound {EMB_F32_REL:.0e})")
    check(rel.max() <= EMB_F32_REL, "f32 signature parity")
    shipped = np.asarray(embed_j(
        *on(gpu, (tsn.rgb.stacked_params, tsn.flow.stacked_params,
                  rgb_ticks, stacks)), dtype="bfloat16"), np.float64)
    cos = (shipped * ref).sum(1) / (np.linalg.norm(shipped, axis=1)
                                    * np.linalg.norm(ref, axis=1))
    log(f"[parity] signatures shipped bf16 vs CPU f32: min cosine "
        f"{cos.min():.6f} (bound {EMB_SHIPPED_COS})")
    check(cos.min() >= EMB_SHIPPED_COS, "shipped signature parity")


# -- phase 4: the service path ------------------------------------------------

def _topk_ids(scores: dict, k: int) -> list[int]:
    return [c for c, _ in sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))][:k]


def phase_serve(ctx: dict) -> None:
    from http.server import ThreadingHTTPServer

    from videoquery.core.config import (STATE_FINALIZED, STATE_PROCESSED,
                                        HyperParams)
    from videoquery.index.csvio import read_feature_tree
    from videoquery.search.engine import SearchEngine
    from videoquery.service import broker, loader
    from videoquery.service.client import ActionClient, HTTPTransport
    from videoquery.testing import serve_fake_api as fake

    root = ctx["features"]
    fixtures = os.path.join(HERE, "tests", "data", "features")
    for corpus in sorted(os.listdir(fixtures)):
        src = os.path.join(fixtures, corpus)
        if os.path.isdir(src):
            for video in sorted(os.listdir(src)):
                shutil.copytree(os.path.join(src, video),
                                os.path.join(root, video))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), fake.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}/"
    env = {"API_CLIENT_USERNAME": "smoke", "API_CLIENT_PASSWORD": "smoke",
           "COMPUTE_EPS": "1e-6", "RANDOM_SEED": str(ctx["seed"]),
           "BASE_URL": base, "BROKER_THREADING": ""}
    old_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    old_cwd = os.getcwd()
    os.chdir(ctx["work"])  # broker writes logs/ and final_reports/ here
    try:
        loader.main([root, "--base_url", base])
        api = fake.api
        with fake.lock:
            clip_ids = sorted({f["video_clip"] for f in api.features.values()})
            ref = next(c for c in clip_ids if api.videos[
                api.video_clips[c]["video"]]["name"].startswith("smoke_video"))
            ss = api.add_search_set("smoke", clip_ids)
            q = api.add_query("smoke", api.video_clips[ref]["video"],
                              api.video_clips[ref]["clip"], ref, ss["id"],
                              max_matches_for_review=10)
        log(f"[serve] ingested {len(api.features)} features of "
            f"{len(clip_ids)} clips over HTTP; query {q['id']}")
        client = ActionClient(HTTPTransport(base))

        def state():
            return client.action(["queries", "read"],
                                 {"id": q["id"]})["process_state"]

        def latest_matches():
            results = [r for r in api.query_results.values()
                       if r["query"] == q["id"]]
            last = max(results, key=lambda r: r["round"])
            return last, [m for m in api.matches.values()
                          if m["query_result"] == last["id"]]

        for step, want_round in (("new", 1), ("revise", 2)):
            if step == "revise":
                _, ms = latest_matches()
                for i, m in enumerate(sorted(ms, key=lambda m: -m["score"])):
                    client.action(["matches", "partial_update"],
                                  {"id": m["id"], "user_match": i < 3})
                client.action(["queries", "partial_update"],
                              {"id": q["id"], "process_state": 2})
            t0 = time.perf_counter()
            broker.main()
            res, ms = latest_matches()
            log(f"[serve] broker {step} round: {time.perf_counter() - t0:.2f}"
                f" s, state {state()}, round {res['round']}, "
                f"{len(ms)} matches")
            check(state() == STATE_PROCESSED and res["round"] == want_round
                  and ms, f"{step} round did not complete")
        client.action(["queries", "partial_update"],
                      {"id": q["id"], "process_state": 6})
        broker.main()
        reports = os.listdir(os.path.join(ctx["work"], "final_reports"))
        log(f"[serve] finalize: state {state()}, reports {reports}")
        check(state() == STATE_FINALIZED and reports
              and q["id"] in api.uploaded_reports, "finalize")
    finally:
        os.chdir(old_cwd)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        srv.shutdown()
        srv.server_close()

    # device top-k == float64 exact engine on this search set, for targets
    # taken from the reference's own clips (vendored fixture features)
    index = loader.load_index(root, keep_host=True)
    hp = HyperParams()
    weights = dict(zip(hp.streams, (1.0, 1.5)))
    dev_engine, exact = SearchEngine(index), SearchEngine(index, exact=True)
    per_clip: dict = {}
    for video, split, csvf in read_feature_tree(root):
        if not video.startswith("smoke_video"):
            for no, vec in zip(csvf.clip_numbers, csvf.features):
                per_clip.setdefault((video, int(no)), {}).setdefault(
                    csvf.stream, {})[split] = np.asarray(vec).tolist()
    keys = sorted(per_clip)
    rng = np.random.default_rng(ctx["seed"])
    targets = [per_clip[keys[i]] for i in
               rng.choice(len(keys), size=min(8, len(keys)), replace=False)]
    tables = dev_engine.compute_similarities_multi(targets)
    for t, tbl in zip(targets, tables):
        got = _topk_ids(tbl.scores(weights), 10)
        want = _topk_ids(exact.compute_similarities(t).scores(weights), 10)
        check(got == want, f"device top-10 {got} != exact {want}")
    log(f"[serve] device top-10 == float64 exact for {len(targets)} targets "
        f"over {index.n_clips} clips")


# -- phase 5: scale -----------------------------------------------------------

N_CLUSTERS = 1000


def cluster_centers(seed: int) -> np.ndarray:
    """[N_CLUSTERS, 1024] f32 unit-scale directions (norm ~1)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_CLUSTERS, 1024)) / 32).astype(np.float32)


def make_search_set(n: int, seed: int, sharding=None):
    """FeatureIndex of n segments, all present: bf16 [2, 3, n, 1024] made on
    the device one (stream, split) slab at a time. Segment i lies near
    cluster center i % N_CLUSTERS (10% noise), so a query near a center has
    n / N_CLUSTERS close neighbors and a revise round a populated band."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from videoquery.core.meshes import DATA_AXIS
    from videoquery.index.store import FeatureIndex

    centers = jnp.asarray(cluster_centers(seed))

    def slab(key, c):
        rows = jnp.arange(n) % N_CLUSTERS
        noise = jax.random.normal(key, (n, 1024), jnp.float32) / 320
        return (c[rows] + noise).astype(jnp.bfloat16)

    keys = jax.random.split(jax.random.PRNGKey(seed), 6)
    slab_sharding = None
    if sharding is not None:  # each card generates its own rows
        slab_sharding = NamedSharding(sharding.mesh, P(DATA_AXIS, None))
    gen = jax.jit(slab, out_shardings=slab_sharding)
    slabs = [gen(k, centers) for k in keys]
    feats = jax.jit(lambda *s: jnp.stack(s).reshape(2, 3, n, 1024),
                    out_shardings=sharding)(*slabs)
    del slabs
    mask = jax.jit(lambda: jnp.ones((2, 3, n), bool),
                   out_shardings=None if sharding is None else NamedSharding(
                       sharding.mesh, P(None, None, DATA_AXIS)))()
    return FeatureIndex(np.arange(1, n + 1, dtype=np.int64), feats, mask,
                        ("rgb", "warped_optical_flow"), (1, 2, 3),
                        "global_pool")


def random_queries(q: int, seed: int):
    """q targets, query i near cluster center i (the set's rows i,
    i + N_CLUSTERS, ... are its close neighbors)."""
    rng = np.random.default_rng(seed + 1)
    c = cluster_centers(seed)[:q]
    t = (c[:, None, None] + rng.normal(size=(q, 2, 3, 1024)) / 320
         ).astype(np.float32)
    w = np.ones((q, 2), np.float32)
    w[:, 1] = 1.5
    return t, np.ones((q, 2, 3), bool), w


def exact_scores(feats_bf16: np.ndarray, targets, weights) -> np.ndarray:
    """float64 reference of _local_query's scores [n, Q] on a host copy
    (all masks set; targets rounded to bf16 as the device path rounds
    them)."""
    import ml_dtypes

    t = targets.astype(ml_dtypes.bfloat16).astype(np.float64)  # [Q,S,K,D]
    s_, k_ = feats_bf16.shape[:2]
    sims = np.stack([np.stack([feats_bf16[si, ki].astype(np.float64)
                               @ t[:, si, ki].T for ki in range(k_)])
                     for si in range(s_)])              # [S, K, n, Q]
    avg = sims.mean(axis=1)                             # [S, n, Q]
    w = weights.astype(np.float64).T[:, None, :]        # [S, 1, Q]
    dev = w * (1.0 - avg)
    return 1.0 - np.sqrt((dev * dev).sum(0) / (w * w).sum(0))


def same_topk(ids_a, vals_a, ids_b, vals_b, tie: float = SCORE_TIE) -> bool:
    """Two top-k lists (descending) agree: equal scores within `tie`, and
    any id that differs sits within `tie` of a score in the other list
    (a reordering among near-equal scores, not a different answer)."""
    if not np.allclose(vals_a, vals_b, rtol=0, atol=tie):
        return False
    for ia, va, ib, vb in ((ids_a, vals_a, ids_b, vals_b),
                           (ids_b, vals_b, ids_a, vals_a)):
        for i, v in zip(ia, va):
            if i not in ib and abs(v - vb[-1]) > tie:
                return False
            if i in ib and abs(v - vb[list(ib).index(i)]) > tie:
                return False
    return True


def phase_scale(ctx: dict) -> None:
    import random as pyrandom

    import jax

    from videoquery.core.config import HyperParams, SearchConfig
    from videoquery.core.meshes import make_mesh
    from videoquery.search.distributed import ShardedSearch, _local_query
    from videoquery.search.engine import SearchEngine
    from videoquery.search.selection import select_clips_to_review

    sizes, seed = ctx["sizes"], ctx["seed"]
    t0 = time.perf_counter()
    index = make_search_set(sizes.segments, seed)
    jax.block_until_ready(index.feats)
    log(f"[scale] search set {tuple(index.feats.shape)} "
        f"{index.feats.dtype} ({index.feats.nbytes / 1e9:.1f} GB) built in "
        f"{time.perf_counter() - t0:.1f} s")
    t, m, w = random_queries(sizes.queries, seed)
    search = ShardedSearch(index, make_mesh(jax.devices()[:1]))
    td, md, wd = (jax.device_put(a) for a in (t, m, w))
    search.topk(td, md, wd, k=10)   # compile
    t0 = time.perf_counter()
    vals, ids = search.topk(td, md, wd, k=10)
    log(f"[scale] {sizes.queries} queries over {sizes.segments} segments: "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms (incl. the [Q, k] "
        f"download)")
    check(np.isfinite(vals).all() and (ids > 0).all(), "query results")

    # one revise round through the resident banded path
    hp = HyperParams()
    check(sizes.segments >= SearchConfig().big_round_threshold
          or ctx["rehearse"], "scale set below the resident threshold")
    rng = np.random.default_rng(seed)
    target = {s: {k: t[0, si, ki].tolist() for ki, k in enumerate((1, 2, 3))}
              for si, s in enumerate(hp.streams)}
    # the user marked ten of the target's cluster as matches, ten others not
    labels = {1 + k * N_CLUSTERS: 1.0
              for k in range(min(10, sizes.segments // N_CLUSTERS))}
    labels.update({int(c): 0.0 for c in
                   rng.choice(sizes.segments, 10, replace=False) + 1
                   if c % N_CLUSTERS})
    t0 = time.perf_counter()
    tbl = SearchEngine(index).compute_similarities_multi(
        [target], resident=True)[0]
    hp_round, _ = tbl.optimize(labels, hp)
    scores = tbl.round_scores(hp_round.weights, hp_round.threshold,
                              hp.near_miss_default, keep_ids=[1])
    check(scores is not None, "banded round overflowed its caps")
    picked = select_clips_to_review(scores, {}, 1, hp_round.threshold, 20,
                                    hp.near_miss_default,
                                    rng=pyrandom.Random(seed))
    log(f"[scale] resident revise round (first, incl. compile): "
        f"{time.perf_counter() - t0:.2f} s, {len(scores)} banded scores, "
        f"{len(picked)} clips selected")
    check(len(picked) > 0, "revise round selected nothing")

    # device top-k == float64 on a slice
    n = sizes.parity_segments
    sl = np.asarray(index.feats[:, :, :n])
    v_dev, i_dev = jax.jit(lambda f_, m_, t_, tm_, w_: _local_query(
        f_, m_, t_, tm_, w_, k=10))(index.feats[:, :, :n],
                                    index.mask[:, :, :n], td, md, wd)
    score = exact_scores(sl, t, w)                      # [n, Q] float64
    got, vals = np.asarray(i_dev), np.asarray(v_dev)
    err = max(np.abs(vals[q] - score[got[q], q]).max()
              for q in range(got.shape[0]))
    identical = 0
    for qi in range(got.shape[0]):
        want = np.argsort(-score[:, qi], kind="stable")[:10]
        identical += int(np.array_equal(got[qi], want))
        if not np.array_equal(got[qi], want):
            log(f"[scale] query {qi}: device {got[qi].tolist()}, float64 "
                f"{want.tolist()}; float64 scores of the device ids "
                f"{score[got[qi], qi].tolist()}")
        check(same_topk(got[qi], vals[qi], want, score[want, qi]),
              f"query {qi}: device top-10 differs from float64 beyond "
              f"{SCORE_TIE} ties")
    log(f"[scale] _local_query top-10 vs float64 over a {n}-segment slice: "
        f"{identical} of {sizes.queries} identical, the rest reordered only "
        f"among scores within {SCORE_TIE}; max |f32 - float64| score "
        f"{err:.2e}")


# -- four cards ---------------------------------------------------------------

def phase_four_cards(ctx: dict) -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from videoquery.core.meshes import DATA_AXIS, make_mesh
    from videoquery.pipeline.extract import Extractor, gather_signatures
    from videoquery.search.distributed import ShardedSearch, _local_query
    from videoquery.testing.synthetic import textured_motion_video

    sizes, seed = ctx["sizes"], ctx["seed"]
    devs = jax.devices()
    check(len(devs) >= 4, f"--chips 4 needs 4 devices, found {len(devs)}")
    mesh = make_mesh(devs[:4])
    t, m, w = random_queries(sizes.queries, seed)

    # 1M segments: data=4 ShardedSearch == one-card _local_query
    index = make_search_set(sizes.segments, seed)
    one = jax.jit(lambda f_, m_, t_, tm_, w_: _local_query(
        f_, m_, t_, tm_, w_, k=10))
    v1, i1 = one(index.feats, index.mask, *(jax.device_put(a) for a in (t, m, w)))
    search = ShardedSearch(index, mesh)
    rep = NamedSharding(mesh, P())
    td, md, wd = (jax.device_put(a, rep) for a in (t, m, w))
    search.topk(td, md, wd, k=10)  # compile
    t0 = time.perf_counter()
    v4, ids4 = search.topk(td, md, wd, k=10)
    dt = time.perf_counter() - t0
    i1, v1 = np.asarray(i1), np.asarray(v1)
    same = [np.array_equal(ids4[q] - 1, i1[q]) for q in range(len(i1))]
    check(all(same_topk(ids4[q] - 1, v4[q], i1[q], v1[q])
              for q in range(len(i1))), "4-card top-10 != one-card top-10")
    log(f"[4-card] data=4 ShardedSearch over {sizes.segments} segments: "
        f"{dt * 1e3:.2f} ms for {sizes.queries} queries; top-10 identical "
        f"to one card for {sum(same)} of {len(same)} queries, the rest "
        f"reordered only among scores within {SCORE_TIE}")
    del index, search, v1, i1
    gc.collect()

    # 4M segments: 12.3 GB per card
    n4 = 4 * sizes.segments
    t0 = time.perf_counter()
    big = make_search_set(n4, seed + 1, NamedSharding(
        mesh, P(None, None, DATA_AXIS, None)))
    jax.block_until_ready(big.feats)
    log(f"[4-card] {n4}-segment set built in {time.perf_counter() - t0:.1f} s "
        f"({big.feats.nbytes / 4e9:.1f} GB per card)")
    search = ShardedSearch(big, mesh)
    search.topk(td, md, wd, k=10)
    t0 = time.perf_counter()
    vals, ids = search.topk(td, md, wd, k=10)
    log(f"[4-card] {sizes.queries} queries over {n4} segments: "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    check(np.isfinite(vals).all() and (ids > 0).all(), "4M query results")
    del big, search
    gc.collect()

    # 32-clip extraction batch sharded over 4 cards == one card
    cfg = dataclasses.replace(ctx["cfg"], batch_clips=32)
    frames = textured_motion_video(32 * cfg.frames_per_clip, *sizes.hw,
                                   np.random.default_rng(seed))
    ex4 = Extractor(ctx["tsn"], cfg, dtype="bfloat16", tvl1=ctx["tvl1"],
                    mesh=mesh)
    t0 = time.perf_counter()
    s4 = gather_signatures(list(ex4.extract_frames(frames)))
    log(f"[4-card] 32-clip batch on 4 cards (incl. compile): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s4 = gather_signatures(list(ex4.extract_frames(frames)))
    log(f"[4-card] 32-clip batch on 4 cards: {time.perf_counter() - t0:.2f} s")
    ex1 = Extractor(ctx["tsn"], dataclasses.replace(cfg, batch_clips=8),
                    dtype="bfloat16", tvl1=ctx["tvl1"])
    s1 = gather_signatures(list(ex1.extract_frames(frames)))
    a = np.concatenate([np.concatenate([s.rgb, s.flow]) for s in s4], axis=1)
    b = np.concatenate([np.concatenate([s.rgb, s.flow]) for s in s1], axis=1)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    log(f"[4-card] sharded vs one-card signatures: min cosine {cos.min():.6f}"
        f" (bound {EMB_SHIPPED_COS})")
    check(cos.min() >= EMB_SHIPPED_COS, "4-card extraction parity")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of all generated data and weights")
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card phases")
    ap.add_argument("--rehearse", action="store_true",
                    help="dry-run the control flow on any device at tiny "
                         "sizes; always exits nonzero and prints no result")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "videoquery")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(videoquery/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from videoquery.core.jaxsetup import setup_jax

    cache = setup_jax()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" and not args.rehearse:
        print(f"chip_smoke.py needs a GPU; JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 1
    log(f"[device] {devices[0].platform} {devices[0].device_kind} x "
        f"{len(devices)}; jax {jax.__version__}; compile cache {cache}")

    sizes = Sizes.rehearsal() if args.rehearse else Sizes()
    cfg, tvl1, tsn = extraction_setup(args.seed, sizes, args.rehearse)
    phases = Phases()
    with tempfile.TemporaryDirectory(prefix="vq_smoke_") as work:
        ctx = dict(seed=args.seed, sizes=sizes, cfg=cfg, tvl1=tvl1, tsn=tsn,
                   work=work, rehearse=args.rehearse)
        if args.chips == 4:
            with phases.run("four-cards"):
                phase_four_cards(ctx)
        else:
            for name, fn in (("extract", phase_extract),
                             ("parity", phase_parity),
                             ("serve", phase_serve),
                             ("scale", phase_scale)):
                with phases.run(name):
                    fn(ctx)
                gc.collect()
    if phases.failed:
        print(f"chip_smoke.py: failed phases: {phases.failed}",
              file=sys.stderr)
        return 1
    if args.rehearse:
        print("rehearsal passed (no result: not a chip run)", file=sys.stderr)
        return 3
    log(card_name_and_power())
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
