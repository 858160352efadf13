"""End-to-end extraction pipeline on synthetic video (small nets for speed)."""

import os

import jax
import numpy as np
import pytest

from videoquery.core.config import ExtractionConfig
from videoquery.kernels.tvl1 import TVL1Params
from videoquery.nn.tsn import TwoStreamTSN
from videoquery.pipeline import decode
from videoquery.pipeline.extract import Extractor


@pytest.fixture(scope="module")
def small_cfg():
    # tiny geometry to keep CPU tests quick; same code path as production
    # min_tail 1 s so a 6-frame tail clip exists (at fps=5, the reference's
    # 2 s minimum equals a full 2 s clip and no tail could ever form)
    # decode_at_target=False keeps CPU flow at the small synthetic
    # resolution (the decode-at-target path is covered by its own test)
    return ExtractionConfig(fps=5, clip_seconds=2, num_ticks=5,
                            frame_resize=(340, 256), batch_clips=2,
                            min_tail_seconds=1, decode_at_target=False)


@pytest.fixture(scope="module")
def tsn():
    return TwoStreamTSN.random(jax.random.PRNGKey(0), splits=(1, 2))


@pytest.fixture(scope="module")
def synthetic_frames():
    rng = np.random.default_rng(0)
    import cv2

    base = rng.integers(0, 255, (160, 240, 3), np.uint8)
    base = cv2.GaussianBlur(base, (15, 15), 4)
    frames = []
    for i in range(26):  # 2 full 10-frame clips + 6-frame (>=2s) tail
        M = np.float32([[1, 0, -2 * i], [0, 1, -1 * i]])
        frames.append(cv2.warpAffine(base, M, (240, 160)))
    return np.stack(frames)


@pytest.fixture(scope="module")
def signatures(tsn, small_cfg, synthetic_frames):
    ex = Extractor(tsn, small_cfg, warped=True,
                   tvl1=TVL1Params(n_scales=3, n_warps=2, n_iters=8))
    return ex, list(ex.extract_frames(synthetic_frames))


def test_extract_shapes_and_clip_count(signatures, small_cfg):
    ex, sigs = signatures
    clip_nums = [n for s in sigs for n in s.clip_numbers]
    assert sorted(clip_nums) == [1, 2, 3]  # 2 full + 1 tail clip
    for s in sigs:
        assert s.rgb.shape[0] == 2 and s.rgb.shape[2] == 1024
        assert s.flow.shape == s.rgb.shape
        assert np.isfinite(s.rgb).all() and np.isfinite(s.flow).all()
        assert (s.rgb >= 0).all()  # global_pool is post-ReLU


def test_extract_csv_tree_roundtrip(signatures, tmp_path, small_cfg):
    from videoquery.index.csvio import read_feature_tree
    from videoquery.service.loader import load_index

    ex, sigs = signatures
    paths = ex.write_csv_tree(sigs, str(tmp_path), "synth", "file://synth")
    assert len(paths) == 4  # 2 splits x 2 streams
    seen = list(read_feature_tree(str(tmp_path)))
    assert len(seen) == 4
    for video, split, csvf in seen:
        assert csvf.features.shape == (3, 1024)
        assert list(csvf.clip_numbers) == [1, 2, 3]
    idx = load_index(str(tmp_path), feature_dim=1024)
    assert idx.n_clips == 3


def test_extracted_features_rank_self_highest(signatures, small_cfg):
    """Query the extracted corpus with clip 1's own scaled features: clip 1
    must rank first with score 1.0 — the minimum end-to-end slice of
    BASELINE.json config 1."""
    from videoquery.index.store import FeatureIndex
    from videoquery.search.engine import SearchEngine
    from videoquery.search.target import scale_feature

    ex, sigs = signatures
    records = ex.records(sigs)
    index = FeatureIndex.build(records, ("rgb", "warped_optical_flow"),
                               keep_host=True)
    ref = {}
    for r in records:
        if r.clip_id == 1:
            ref.setdefault(r.stream, {})[r.split] = scale_feature(r.vector)
    table = SearchEngine(index, exact=True).compute_similarities(ref)
    scores = table.scores({"rgb": 1.0, "warped_optical_flow": 1.5})
    assert max(scores, key=lambda c: scores[c]) == 1
    np.testing.assert_allclose(scores[1], 1.0, atol=1e-9)


def test_synthesize_and_decode_video(tmp_path):
    path = str(tmp_path / "v.mp4")
    decode.synthesize_video(path, n_frames=30, size=(160, 120))
    frames = decode.load_video(path)
    assert frames.shape == (30, 120, 160, 3)
    assert frames.dtype == np.uint8


def test_reduced_pair_flow_matches_full(rng):
    """The reduced-pair flow plan must produce the same embeddings as
    solving every frame pair of the clip (stack slots then index the full
    pair list directly: pair_idx[pos] is the clamped frame index)."""
    import jax.numpy as jnp

    from videoquery.kernels.tvl1 import TVL1Params
    from videoquery.nn.tsn import StreamEnsemble, TwoStreamTSN
    from videoquery.pipeline.extract import _extract_step
    from videoquery.pipeline.sampling import flow_pair_plan, frame_ticks

    tsn = TwoStreamTSN(
        StreamEnsemble.random(jax.random.PRNGKey(0), 3, splits=(1,)),
        StreamEnsemble.random(jax.random.PRNGKey(1), 10, splits=(1,)),
    )
    frames = jnp.asarray(rng.integers(0, 255, (1, 12, 64, 80, 3)), jnp.uint8)
    ticks = jnp.asarray(frame_ticks(12, 2, 1) - 1, jnp.int32)
    pair_idx, stack_pos = flow_pair_plan(12, 2, 5)
    assert len(pair_idx) < 11  # the plan really skips unconsumed pairs
    tvl1 = TVL1Params(n_scales=2, n_warps=1, n_iters=4)
    common = dict(bound=20.0, warped=False, tvl1=tvl1, cfg_resize=(120, 96),
                  cfg_crop=64, dtype_str="float32")
    r_pair, f_pair = _extract_step(
        tsn.rgb.stacked_params, tsn.flow.stacked_params, frames, ticks,
        jnp.asarray(stack_pos, jnp.int32),
        flow_pair_idx=jnp.asarray(pair_idx, jnp.int32), **common)
    r_full, f_full = _extract_step(
        tsn.rgb.stacked_params, tsn.flow.stacked_params, frames, ticks,
        jnp.asarray(pair_idx[stack_pos], jnp.int32),
        flow_pair_idx=jnp.arange(11, dtype=jnp.int32), **common)
    np.testing.assert_allclose(np.asarray(r_pair), np.asarray(r_full),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(f_pair), np.asarray(f_full),
                               rtol=1e-5, atol=1e-6)


def test_gather_signatures_mixed(rng):
    """gather_signatures handles a mix of host and device signatures."""
    import jax.numpy as jnp

    from videoquery.pipeline.extract import ClipSignatures, gather_signatures

    host = ClipSignatures([1], rng.normal(size=(2, 1, 8)).astype(np.float32),
                          rng.normal(size=(2, 1, 8)).astype(np.float32), (1, 2))
    dev_rgb = jnp.asarray(rng.normal(size=(2, 3, 8)), jnp.float32)
    dev_flow = jnp.asarray(rng.normal(size=(2, 3, 8)), jnp.float32)
    dev = ClipSignatures([2, 3, 4], dev_rgb, dev_flow, (1, 2))
    out = gather_signatures([host, dev])
    assert all(isinstance(s.rgb, np.ndarray) for s in out)
    np.testing.assert_array_equal(out[0].rgb, host.rgb)
    np.testing.assert_allclose(out[1].rgb, np.asarray(dev_rgb), rtol=1e-6)
    np.testing.assert_allclose(out[1].flow, np.asarray(dev_flow), rtol=1e-6)
    assert out[1].clip_numbers == [2, 3, 4]


def test_parallel_decode_matches_sequential(tmp_path):
    """Seek-based chunked decode must be frame-exact vs the sequential
    reader (including the skip-first-frame parity rule)."""
    from videoquery.pipeline import decode

    path = str(tmp_path / "v.mp4")
    decode.synthesize_video(path, n_frames=130, size=(64, 48))
    seq = decode.load_video(path)
    par = decode.load_video_parallel(path, workers=4, chunk=40)
    assert par.shape == seq.shape
    np.testing.assert_array_equal(par, seq)


def test_resize_matches_cv2_oracle(rng):
    """The parity-normative resize: the reference resizes every frame with
    cv2.resize INTER_LINEAR inside caffe-action (calcSig_wOF.py:94,111).
    jax.image.resize antialiases on downscale (up to 132/255 divergence on
    640x480 input!); _resize must match cv2's two-tap kernel on BOTH down-
    and upscale. Float oracle to float32 accumulation tolerance; the uint8
    path only adds cv2's fixed-point rounding (<=~1.5 LSB)."""
    import cv2

    from videoquery.pipeline.preprocess import _resize

    for h0, w0 in [(480, 640), (240, 320), (257, 341), (720, 1280)]:
        img = rng.integers(0, 255, (h0, w0, 3), np.uint8)
        oracle_f = cv2.resize(img.astype(np.float32), (340, 256),
                              interpolation=cv2.INTER_LINEAR)
        oracle_u8 = cv2.resize(img, (340, 256),
                               interpolation=cv2.INTER_LINEAR)
        import jax.numpy as jnp

        got = np.asarray(_resize(jnp.asarray(img, jnp.float32), 340, 256))
        assert np.abs(got - oracle_f).max() <= 5e-3, (h0, w0)
        assert np.abs(got - oracle_u8.astype(np.float32)).max() <= 2.0


def test_preprocess_rgb_matches_cv2_oracle(rng):
    """Full preprocess chain (resize -> center crop -> BGR mean subtract)
    against a cv2-based oracle on a batch of frames."""
    import cv2
    import jax.numpy as jnp

    from videoquery.pipeline.preprocess import BGR_MEAN, preprocess_rgb

    frames = rng.integers(0, 255, (3, 480, 640, 3), np.uint8)
    got = np.asarray(preprocess_rgb(jnp.asarray(frames)))
    for i in range(3):
        r = cv2.resize(frames[i].astype(np.float32), (340, 256),
                       interpolation=cv2.INTER_LINEAR)
        top, left = (256 - 224) // 2, (340 - 224) // 2
        want = r[top:top + 224, left:left + 224] - np.asarray(BGR_MEAN)
        assert np.abs(got[i] - want).max() <= 5e-3


def test_parallel_decode_detects_misaligned_seek(tmp_path, monkeypatch):
    """FFmpeg can seek to a keyframe-approximate position while still
    echoing the requested CAP_PROP_POS_FRAMES; the overlap-frame byte check
    must catch the shifted chunk and fall back to sequential decode."""
    from videoquery.pipeline import decode

    path = str(tmp_path / "v.mp4")
    decode.synthesize_video(path, n_frames=130, size=(64, 48))
    seq = decode.load_video(path)
    real = decode._decode_range

    def shifted(p, start, count, new_size):
        frames = real(p, start, count, new_size)
        if start == 40:  # second chunk "seeks" one frame late
            extra = real(p, start + count, 1, new_size)
            return frames[1:] + extra
        return frames

    monkeypatch.setattr(decode, "_decode_range", shifted)
    par = decode.load_video_parallel(path, workers=4, chunk=40)
    np.testing.assert_array_equal(par, seq)  # fallback result, not shifted


def test_extract_video_stream_propagates_late_decode_error(
        tmp_path, tsn, small_cfg):
    """A decode failure AFTER the first emitted batch must raise, not be
    downgraded to a truncated-video warning with partial features."""
    path = str(tmp_path / "s.mp4")
    decode.synthesize_video(path, n_frames=26, size=(96, 64), fps=5)
    real = decode.video_frames

    def failing(p, new_size=None, skip_first=True):
        for i, f in enumerate(real(p, new_size, skip_first)):
            if i >= 22:  # after the first 2-clip (20-frame) batch
                raise RuntimeError("mid-video decode failure")
            yield f

    import videoquery.pipeline.extract as extract_mod
    ex = Extractor(tsn, small_cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    orig = extract_mod.decode.video_frames
    extract_mod.decode.video_frames = failing
    try:
        with pytest.raises(RuntimeError, match="mid-video"):
            ex.extract_video_stream(path)
    finally:
        extract_mod.decode.video_frames = orig


def test_tail_clip_padding_is_identical(tsn, small_cfg, synthetic_frames):
    """Tail clips are padded to frames_per_clip for compile-geometry reuse;
    the ticks/stacks never index the padding, so signatures must be
    IDENTICAL to running the unpadded tail through the device program."""
    import jax.numpy as jnp

    from videoquery.pipeline.extract import _extract_step
    from videoquery.pipeline.sampling import frame_ticks, flow_pair_plan

    ex = Extractor(tsn, small_cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    sigs = {n: s for s in ex.extract_frames(synthetic_frames)
            for n in s.clip_numbers}
    # clip 3 is the 6-frame tail (26 frames, 10/clip, min_tail 1 s @ 5 fps)
    got = np.asarray(sigs[3].rgb)[:, list(sigs[3].clip_numbers).index(3)]

    tail = synthetic_frames[20:26]                     # frames 21..26
    cfg = small_cfg
    ticks = frame_ticks(6, cfg.num_ticks, 1) - 1
    pair_idx, stack_pos = flow_pair_plan(6, cfg.num_ticks,
                                         cfg.flow_stack_depth)
    rgb, _ = _extract_step(
        tsn.rgb.stacked_params, tsn.flow.stacked_params,
        jnp.asarray(tail[None]), jnp.asarray(ticks, jnp.int32),
        jnp.asarray(stack_pos, jnp.int32), cfg.flow_bound, False,
        TVL1Params(n_scales=2, n_warps=1, n_iters=4), cfg.frame_resize,
        cfg.crop_size, "float32", jnp.asarray(pair_idx, jnp.int32),
        cfg.flow_res_div)
    np.testing.assert_allclose(got, np.asarray(rgb)[:, 0], rtol=1e-5,
                               atol=1e-5)


def test_decode_at_target_scale(tmp_path, tsn):
    """decode_at_target decodes straight to frame_resize: identical
    signatures when the source already IS frame_resize (same-size
    cv2.resize is the identity), and a fixed flow geometry for other
    sources."""
    cfg = dict(fps=5, clip_seconds=2, num_ticks=3, frame_resize=(120, 96),
               crop_size=64, batch_clips=2, min_tail_seconds=1)
    tvl1 = TVL1Params(n_scales=2, n_warps=1, n_iters=4)
    path = str(tmp_path / "native.mp4")
    decode.synthesize_video(path, n_frames=20, size=(120, 96))
    ex_on = Extractor(tsn, ExtractionConfig(decode_at_target=True, **cfg),
                      warped=False, tvl1=tvl1)
    ex_off = Extractor(tsn, ExtractionConfig(decode_at_target=False, **cfg),
                       warped=False, tvl1=tvl1)
    a = ex_on.extract_video(path)
    b = ex_off.extract_video(path)
    for s1, s2 in zip(a, b):
        np.testing.assert_allclose(np.asarray(s1.rgb), np.asarray(s2.rgb),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(s1.flow), np.asarray(s2.flow),
                                   rtol=1e-5, atol=1e-6)
    # a different native resolution decodes into the SAME device geometry
    path2 = str(tmp_path / "big.mp4")
    decode.synthesize_video(path2, n_frames=20, size=(160, 128))
    c = ex_on.extract_video(path2)
    assert c[0].rgb.shape == a[0].rgb.shape
    assert np.isfinite(np.asarray(c[0].rgb)).all()


def test_extract_video_stream_matches_batch(tmp_path, tsn, small_cfg):
    """Streaming (decode-overlapped) extraction must produce the same
    signatures as load-then-extract."""
    from videoquery.pipeline.extract import gather_signatures

    path = str(tmp_path / "s.mp4")
    decode.synthesize_video(path, n_frames=26, size=(96, 64), fps=5)
    ex = Extractor(tsn, small_cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    want = ex.extract_video(path)
    got = ex.extract_video_stream(path)
    assert [s.clip_numbers for s in got] == [s.clip_numbers for s in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a.rgb), np.asarray(b.rgb),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(a.flow), np.asarray(b.flow),
                                   rtol=1e-5, atol=1e-6)


def test_extract_video_stream_underreported_count_regroups(
        tmp_path, tsn, small_cfg):
    """A container that UNDER-reports its frame count (VFR duration*fps
    estimates) grows the full-clip list at replan time; the replan must
    dispatch only the undone clips. The old whole-group skip re-dispatched
    a group straddling the done/undone boundary — duplicating done clips
    and np.stack-ing over frames the streaming loop had already freed."""
    path = str(tmp_path / "s.mp4")
    # 36 frames -> 35 usable: 3 full 10-frame clips + 5-frame (>=1 s) tail
    decode.synthesize_video(path, n_frames=36, size=(96, 64), fps=5)
    ex = Extractor(tsn, small_cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    want = ex.extract_video(path)

    import videoquery.pipeline.extract as extract_mod
    orig = extract_mod.decode.probe_frame_count
    # report 16 -> usable 15: the streamed plan sees ONE full clip (a short
    # chunk at batch_clips=2), so the replan's first full group [c1, c2]
    # straddles the done boundary
    extract_mod.decode.probe_frame_count = lambda p: 16
    try:
        got = ex.extract_video_stream(path)
    finally:
        extract_mod.decode.probe_frame_count = orig
    got_nums = [n for s in got for n in s.clip_numbers]
    assert sorted(got_nums) == [1, 2, 3, 4]  # every clip exactly once
    want_by_num = {n: np.asarray(s.rgb)[:, i]
                   for s in want for i, n in enumerate(s.clip_numbers)}
    for s in got:
        for i, n in enumerate(s.clip_numbers):
            np.testing.assert_allclose(np.asarray(s.rgb)[:, i],
                                       want_by_num[n], rtol=1e-5, atol=1e-6)


def test_extract_video_stream_backpressure_window(tmp_path, tsn, small_cfg):
    """With the minimum stream window (2 batches) the producer must block
    and resume across many batches without deadlocking, and signatures must
    match load-then-extract (liveness + correctness of the
    window/drain handshake)."""
    import dataclasses as dc

    path = str(tmp_path / "s.mp4")
    # 101 frames -> 100 usable: 10 full clips = 5 batches of 2
    decode.synthesize_video(path, n_frames=101, size=(96, 64), fps=5)
    cfg = dc.replace(small_cfg, stream_window_batches=2)
    ex = Extractor(tsn, cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    want = ex.extract_video(path)
    got = ex.extract_video_stream(path)
    assert [s.clip_numbers for s in got] == [s.clip_numbers for s in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a.rgb), np.asarray(b.rgb),
                                   rtol=1e-5, atol=1e-6)


def test_extraction_config_validates_flow_warm_camera():
    with pytest.raises(ValueError, match="flow_warm_camera"):
        ExtractionConfig(flow_warm_camera="keyframe")


def test_flow_gray_grid_matmul_matches_exact(rng):
    """The matmul-folded gray+flow-grid resize (production,
    ExtractionConfig.flow_gray_matmul) must equal the exact f32
    gray -> jax.image.resize path: the per-axis weight matrices are
    extracted from jax.image.resize itself, so on CPU (f32 operands) the
    two differ only by float association; on the GPU the bf16 operands add
    a < 4e-3 perturbation that is EPE-gated (tools/flow_quality.py --gray)."""
    import jax.numpy as jnp

    from videoquery.pipeline.extract import _flow_gray_grid

    frames = jnp.asarray(rng.integers(0, 255, (2, 5, 256, 340, 3), np.uint8))
    exact, vs_e = _flow_gray_grid(frames, 2, matmul=False)
    fused, vs_m = _flow_gray_grid(frames, 2, matmul=True)
    assert vs_e == vs_m
    assert exact.shape == fused.shape == (2, 5, 128, 170)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(exact),
                               atol=1e-5)
    # a second geometry keeps its native aspect too
    small = jnp.asarray(rng.integers(0, 255, (1, 3, 128, 176, 3), np.uint8))
    a, va = _flow_gray_grid(small, 2, matmul=False)
    b, vb = _flow_gray_grid(small, 2, matmul=True)
    assert a.shape == b.shape == (1, 3, 64, 88) and va == vb == (2.0, 2.0)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5)
    # res_div=1: no resize to fold, exact luma either way
    g1, v1 = _flow_gray_grid(small, 1, matmul=True)
    assert g1.shape == (1, 3, 128, 176) and v1 == (1.0, 1.0)


def test_host_gray_compact_upload_matches_device_gray(tsn, small_cfg,
                                                      synthetic_frames):
    """ExtractionConfig.host_gray ships only tick frames + host-computed
    uint8 gray (compact upload). The rgb stream must be EXACT (the tick
    gather moves to the host, everything after is the same program); the
    flow stream differs only by the gray source (cv2 uint8 area-resize vs
    on-device f32 antialiased linear — box vs triangle kernel) — embeddings
    must stay directionally identical. The 0.97 floor is a plumbing check
    on RANDOM nets over noise frames; flow QUALITY of the host gray source
    is gated by ground-truth EPE + retrieval on the synthetic corpus
    (tools/flow_quality.py --host_gray), which is the normative gate."""
    import dataclasses

    base = Extractor(tsn, small_cfg, warped=True,
                     tvl1=TVL1Params(n_scales=3, n_warps=2, n_iters=8))
    compact = Extractor(
        tsn, dataclasses.replace(small_cfg, host_gray=True), warped=True,
        tvl1=TVL1Params(n_scales=3, n_warps=2, n_iters=8))
    a = [s.materialize() for s in base.extract_frames(synthetic_frames)]
    b = [s.materialize() for s in compact.extract_frames(synthetic_frames)]
    assert [s.clip_numbers for s in a] == [s.clip_numbers for s in b]
    for sa, sb in zip(a, b):
        np.testing.assert_allclose(sb.rgb, sa.rgb, atol=1e-5)
        cos = np.sum(sa.flow * sb.flow, -1) / (
            np.linalg.norm(sa.flow, axis=-1)
            * np.linalg.norm(sb.flow, axis=-1) + 1e-12)
        assert cos.min() > 0.97, f"flow embeddings diverged: cos={cos.min()}"


def test_host_crop_bit_identical_at_target_scale(tsn, small_cfg):
    """ExtractionConfig.host_crop ships tick frames already resized+cropped
    (decode.resize_crop_frames). When the frames already sit at
    frame_resize — the decode_at_target production geometry — the host step
    is PURE SLICING, so rgb and flow embeddings must be bit-identical to
    the host_gray path (the device program only loses a resize+crop that
    was itself slice-only at this geometry)."""
    import dataclasses

    import cv2

    rng = np.random.default_rng(7)
    base = cv2.GaussianBlur(
        rng.integers(0, 255, (256, 340, 3), np.uint8), (15, 15), 4)
    frames = np.stack([
        cv2.warpAffine(base, np.float32([[1, 0, 2.0 * i], [0, 1, 0.7 * i]]),
                       (340, 256))
        for i in range(16)])  # 1 full 10-frame clip + 6-frame tail
    tv = TVL1Params(n_scales=3, n_warps=2, n_iters=8)
    a_ex = Extractor(tsn, dataclasses.replace(small_cfg, host_gray=True),
                     warped=True, tvl1=tv)
    b_ex = Extractor(tsn, dataclasses.replace(small_cfg, host_gray=True,
                                              host_crop=True),
                     warped=True, tvl1=tv)
    a = [s.materialize() for s in a_ex.extract_frames(frames)]
    b = [s.materialize() for s in b_ex.extract_frames(frames)]
    assert [s.clip_numbers for s in a] == [s.clip_numbers for s in b]
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sb.rgb, sa.rgb)
        np.testing.assert_array_equal(sb.flow, sa.flow)


def test_host_crop_native_size_close_to_device_resize(tsn, small_cfg,
                                                      synthetic_frames):
    """At native (non-target) decode sizes host_crop resizes with cv2 on
    uint8 — the reference's own preprocessing (predict_single_frame resizes
    the uint8 frame with cv2 before cropping, calcSig_wOF.py:94) — while
    the device path resizes in f32 (matching the cv2 oracle to <=1.5 LSB).
    The only divergence is cv2's uint8 fixed-point rounding, so rgb
    embeddings stay within tight cosine tolerance and flow embeddings stay
    EXACT (same gray payload either way)."""
    import dataclasses

    tv = TVL1Params(n_scales=3, n_warps=2, n_iters=8)
    a_ex = Extractor(tsn, dataclasses.replace(small_cfg, host_gray=True),
                     warped=True, tvl1=tv)
    b_ex = Extractor(tsn, dataclasses.replace(small_cfg, host_gray=True,
                                              host_crop=True),
                     warped=True, tvl1=tv)
    a = [s.materialize() for s in a_ex.extract_frames(synthetic_frames)]
    b = [s.materialize() for s in b_ex.extract_frames(synthetic_frames)]
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sb.flow, sa.flow)
        cos = np.sum(sa.rgb * sb.rgb, -1) / (
            np.linalg.norm(sa.rgb, axis=-1)
            * np.linalg.norm(sb.rgb, axis=-1) + 1e-12)
        assert cos.min() > 0.999, f"rgb embeddings diverged: cos={cos.min()}"


def test_host_crop_requires_host_gray():
    """host_crop without host_gray would crop the full-clip upload the
    device's gray/flow path still needs — the config must refuse it."""
    with pytest.raises(ValueError, match="host_crop requires host_gray"):
        ExtractionConfig(host_crop=True)


def test_yuv420_device_reconstruction_matches_cv2(rng):
    """extract._yuv420_to_bgr must invert decode.bgr_to_yuv420 exactly the
    way cv2's own decoder does: compare against cv2.cvtColor(YUV2BGR_I420)
    on random frames (the hardest case for the fixed-point constants) —
    <=2 LSB everywhere. This pins the device math to cv2; the information
    LOSS of 4:2:0 itself is covered by the embedding test below and by the
    parity anchor (the reference's rgb inputs all went through 4:2:0 JPEGs,
    build_wof_clips.py:47 / calcSig_wOF.py:92-93)."""
    import cv2

    from videoquery.pipeline.extract import _yuv420_to_bgr

    frames = rng.integers(0, 256, (3, 64, 48, 3), np.uint8)
    yuv = decode.bgr_to_yuv420(frames)
    assert yuv.shape == (3, 96, 48)
    dev = np.asarray(_yuv420_to_bgr(jax.numpy.asarray(yuv)))
    ref = np.stack([cv2.cvtColor(y, cv2.COLOR_YUV2BGR_I420) for y in yuv])
    assert np.abs(dev - ref.astype(np.float32)).max() <= 2.0


def test_host_yuv420_embeddings_close(tsn, small_cfg):
    """host_yuv420 ships tick frames as 4:2:0 (half the rgb payload). The
    flow stream rides the untouched gray payload — embeddings EXACT — and
    the rgb embeddings must stay within tight cosine tolerance of the
    host_crop path (the only change is 2x2 chroma subsampling plus cv2's
    studio-swing Y quantization; the reference applied MORE chroma loss
    than this via JPEG)."""
    import dataclasses

    import cv2

    rng = np.random.default_rng(11)
    base = cv2.GaussianBlur(
        rng.integers(0, 255, (256, 340, 3), np.uint8), (15, 15), 4)
    frames = np.stack([
        cv2.warpAffine(base, np.float32([[1, 0, 2.0 * i], [0, 1, 0.7 * i]]),
                       (340, 256))
        for i in range(16)])
    tv = TVL1Params(n_scales=3, n_warps=2, n_iters=8)
    a_ex = Extractor(tsn, dataclasses.replace(small_cfg, host_gray=True,
                                              host_crop=True),
                     warped=True, tvl1=tv)
    b_ex = Extractor(tsn, dataclasses.replace(small_cfg, host_gray=True,
                                              host_crop=True,
                                              host_yuv420=True),
                     warped=True, tvl1=tv)
    a = [s.materialize() for s in a_ex.extract_frames(frames)]
    b = [s.materialize() for s in b_ex.extract_frames(frames)]
    assert [s.clip_numbers for s in a] == [s.clip_numbers for s in b]
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sb.flow, sa.flow)
        cos = np.sum(sa.rgb * sb.rgb, -1) / (
            np.linalg.norm(sa.rgb, axis=-1)
            * np.linalg.norm(sb.rgb, axis=-1) + 1e-12)
        assert cos.min() > 0.999, f"rgb embeddings diverged: cos={cos.min()}"


def test_host_yuv420_requires_host_crop():
    """host_yuv420 packs the CROPPED tick upload; without host_crop the
    chroma planes would not tile the native frames — must refuse."""
    with pytest.raises(ValueError, match="host_yuv420 requires host_crop"):
        ExtractionConfig(host_gray=True, host_yuv420=True)


def test_gray_flow_grid_matches_device_gray(rng):
    """decode.gray_flow_grid (host cv2 path) approximates the on-device
    gray + flow-grid resize: same shape (flow_grid_shape is shared), and
    values within a few uint8 LSB (u8 quantization + area-vs-linear
    downscale differ in the kernel tail, not the signal)."""
    from videoquery.pipeline.extract import _flow_gray_grid, flow_grid_shape

    frames = rng.integers(0, 255, (6, 256, 340, 3), np.uint8)
    # smooth so interpolation-kernel differences stay small
    import cv2

    frames = np.stack([cv2.GaussianBlur(f, (9, 9), 3) for f in frames])
    fh, fw = flow_grid_shape(256, 340, 2)
    host = decode.gray_flow_grid(frames, fh, fw).astype(np.float32) / 255.0
    dev, vscale = _flow_gray_grid(
        np.asarray(frames)[None], 2, matmul=False)
    dev = np.asarray(dev)[0]
    assert host.shape == dev.shape == (6, fh, fw)
    assert vscale == (340 / fw, 256 / fh)
    assert np.abs(host - dev).max() < 8 / 255.0
    assert np.abs(host.mean() - dev.mean()) < 1 / 255.0


def test_gray_area2_matches_direct_area(rng):
    """The production "area2" interp (exact box prefactor + residual
    INTER_AREA — 2.4x faster; normative quality gate in
    tools/flow_quality.py --host_gray) stays within a couple uint8 LSB of
    direct INTER_AREA on smooth frames, collapses to IDENTICAL bytes when
    the grid is an exact integer downscale or the identity, and handles
    geometries with no usable box prefactor (odd dims -> k == 1)."""
    import cv2

    from videoquery.pipeline.decode import _box_factor

    # (H, W) -> (fh, fw): anisotropic, production half-res (exact /2),
    # identity, odd dims
    cases = [((256, 340), (128, 128)), ((256, 340), (128, 170)),
             ((256, 340), (256, 340)), ((255, 339), (100, 120))]
    for (h, w), (fh, fw) in cases:
        f = cv2.GaussianBlur(
            rng.integers(0, 255, (h, w, 3), np.uint8), (9, 9), 2)
        a = decode.gray_flow_grid(f[None], fh, fw, interp="area")[0]
        b = decode.gray_flow_grid(f[None], fh, fw, interp="area2")[0]
        d = np.abs(a.astype(int) - b.astype(int))
        if (h % fh == 0 and w % fw == 0 and h // fh == w // fw) \
                or (h, w) == (fh, fw):
            assert d.max() == 0, ((h, w), (fh, fw))
        else:
            assert d.max() <= 3 and d.mean() < 0.6, ((h, w), (fh, fw), d.max())
    assert _box_factor(256, 340, 128, 128) == 2
    assert _box_factor(255, 339, 100, 120) == 1
    assert _box_factor(512, 512, 64, 64) == 8
    assert _box_factor(256, 340, 256, 340) == 1


def test_plan_arrays_cached_per_clip_length(tsn, small_cfg):
    """Tick/stack/pair index arrays are uploaded once per clip length and
    reused across batches (five small index uploads per batch saved)."""
    ex = Extractor(tsn, small_cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    p1 = ex._plan_arrays(10)
    p2 = ex._plan_arrays(10)
    assert p1 is p2, "same f_len must hit the cache"
    p3 = ex._plan_arrays(6)
    assert p3 is not p1 and len(ex._plan_cache) == 2
    ticks_np, ticks_dev, stack_dev, pair_dev, warm = p1
    assert ticks_np.min() >= 1 and int(np.asarray(ticks_dev).min()) >= 0


def test_signature_batch_accepts_windowed_list(tsn, small_cfg,
                                               synthetic_frames):
    """The streaming path hands _signature_batch a LIST buffer whose
    already-consumed prefix is freed (None) — constant-memory streaming.
    Embeddings must equal the ndarray path."""
    ex = Extractor(tsn, small_cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    group = [(11, 20), (21, 26)]  # second full clip + would-be ranges
    group = [(11, 20)]
    nums = [2]
    arr_sig = ex._signature_batch(synthetic_frames, None, group,
                                  nums).materialize()
    buf = [None] * 10 + [f for f in synthetic_frames[10:]]
    list_sig = ex._signature_batch(buf, None, group, nums).materialize()
    np.testing.assert_allclose(list_sig.rgb, arr_sig.rgb, atol=1e-5)
    np.testing.assert_allclose(list_sig.flow, arr_sig.flow, atol=1e-5)


def test_stream_releases_consumed_frames(tmp_path, tsn, small_cfg,
                                         monkeypatch):
    """extract_video_stream must not retain every decoded frame: after a
    full batch is dispatched, its frames are released (the whole-video
    buffer was ~14 GB/h of RAM at production geometry)."""
    import videoquery.pipeline.extract as ext

    path = str(tmp_path / "v.mp4")
    decode.synthesize_video(path, n_frames=27, size=(240, 160))
    ex = Extractor(tsn, small_cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    import videoquery.pipeline.payload as pay

    seen_buffers = []
    orig = pay.build_payload

    def spy(frames, gray, group, nums, cfg, flow_res_div):
        seen_buffers.append((frames, [s for s, _e in group]))
        return orig(frames, gray, group, nums, cfg, flow_res_div)

    # streaming builds payloads via payload.build_payload (stream_payloads
    # lives in that module), whether on the producer thread or in mpstream
    # worker processes — patch it there, not extract's re-export
    monkeypatch.setattr(pay, "build_payload", spy)
    ex.extract_video_stream(path)
    # the LAST batch (replan) must observe freed entries from earlier ones
    final_buf, _ = seen_buffers[-1]
    assert isinstance(final_buf, list)
    if len(seen_buffers) > 1:
        n_freed = sum(f is None for f in final_buf)
        assert n_freed > 0, "no frames were released by the streaming path"


def test_extract_video_stream_host_gray_matches_batch(tmp_path, tsn,
                                                      small_cfg):
    """host_gray streaming (producer-thread gray, compact upload, windowed
    buffer) must equal host_gray load-then-extract: the gray values must be
    identical whether computed per frame in the producer or per clip slice
    in the batch path."""
    import dataclasses

    path = str(tmp_path / "hg.mp4")
    decode.synthesize_video(path, n_frames=26, size=(96, 64), fps=5)
    cfg = dataclasses.replace(small_cfg, host_gray=True)
    ex = Extractor(tsn, cfg, warped=False,
                   tvl1=TVL1Params(n_scales=2, n_warps=1, n_iters=4))
    want = ex.extract_video(path)
    got = ex.extract_video_stream(path)
    assert [s.clip_numbers for s in got] == [s.clip_numbers for s in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a.rgb), np.asarray(b.rgb),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(a.flow), np.asarray(b.flow),
                                   rtol=1e-5, atol=1e-6)
