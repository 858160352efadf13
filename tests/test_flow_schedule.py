"""The production flow schedule on the XLA TV-L1 path: tick pair plan,
temporal warm start, and the keyframe camera reused or refined by warm
pairs (kernels/tvl1.py, pipeline/extract.py, pipeline/sampling.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from videoquery.kernels.tvl1 import TVL1Params
from videoquery.kernels.warp import bilinear_warp


def make_texture(rng, h, w):
    import jax.image

    base = jnp.asarray(rng.normal(size=(h // 8, w // 8)))
    img = jax.image.resize(base, (h, w), "cubic")
    return ((img - img.min()) / (img.max() - img.min())).astype(jnp.float32)


def _pan_frames(rng, n, h=48, w=128, step=(2, 3)):
    """n frames of a constant camera pan of `step` = (dx, dy) px/frame."""
    big = make_texture(rng, h + 40, w + 40)
    dx, dy = step
    return jnp.stack([big[8 + dy * t:8 + dy * t + h, 8 + dx * t:8 + dx * t + w]
                      for t in range(n)])


@pytest.mark.parametrize("n_scales", [1, 3])
def test_warm_levels_from_zero_equals_cold(rng, n_scales):
    """tvl1_flow_warm over every pyramid level from a zero init is the cold
    solve exactly (levels=1 on a one-level pyramid is the finest-level
    refinement warm pairs run)."""
    from videoquery.kernels.tvl1 import tvl1_flow, tvl1_flow_warm

    i0 = make_texture(rng, 32, 64)
    i1 = bilinear_warp(i0, 1.0 * jnp.ones_like(i0), -0.5 * jnp.ones_like(i0))
    p = TVL1Params(n_scales=n_scales, n_warps=2, n_iters=6)
    z = jnp.zeros((1, 32, 64), jnp.float32)
    uc, vc = tvl1_flow(i0[None], i1[None], p)
    uw, vw = tvl1_flow_warm(i0[None], i1[None], z, z, p, levels=n_scales)
    np.testing.assert_array_equal(np.asarray(uw), np.asarray(uc))
    np.testing.assert_array_equal(np.asarray(vw), np.asarray(vc))


@pytest.mark.parametrize("camera_model", ["affine", "homography"])
def test_warped_cam_returns_same_flow(rng, camera_model):
    """tvl1_warped_flow_cam returns tvl1_warped_flow's flow plus the camera
    of the configured model."""
    from videoquery.kernels.tvl1 import tvl1_warped_flow, tvl1_warped_flow_cam

    frames = _pan_frames(rng, 3)
    p = TVL1Params(n_scales=2, n_warps=2, n_iters=6, camera_model=camera_model)
    u, v = tvl1_warped_flow(frames[:-1], frames[1:], p)
    uc, vc, cam = tvl1_warped_flow_cam(frames[:-1], frames[1:], p)
    np.testing.assert_array_equal(np.asarray(uc), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(vc), np.asarray(v))
    assert cam.shape == ((2, 3, 3) if camera_model == "homography"
                         else (2, 2, 3))


@pytest.mark.parametrize("start", ["key", "init"])
def test_refine_camera_recovers_pan(rng, start):
    """refine_camera (exact-gather LK, no translation pre-pass) converges
    to the pair's own camera from the keyframe's estimate ("key") and from
    a stale, 1.5 px-off estimate ("init" of a jittered neighbor)."""
    from videoquery.kernels.motion import homography_displacement
    from videoquery.kernels.tvl1 import estimate_camera, refine_camera

    frames = _pan_frames(rng, 2, h=96, w=128)
    p = TVL1Params(camera_model="homography", coarse_hw=(48, 64))
    i0, i1 = frames[:1], frames[1:]
    hn = estimate_camera(i0, i1, p)
    start_h = hn if start == "key" else hn.at[:, 0, 2].add(3.0 / 64)
    got = refine_camera(i0, i1, p, start_h, n_iters=3)
    u, v = homography_displacement(got, 96, 128)
    interior = (slice(None), slice(16, -16), slice(16, -16))
    # the window moves by +(2, 3) px, so the content moves by -(2, 3)
    np.testing.assert_allclose(float(jnp.median(u[interior])), -2.0, atol=0.2)
    np.testing.assert_allclose(float(jnp.median(v[interior])), -3.0, atol=0.2)


def test_extractor_always_builds_pair_plan():
    """Every Extractor solves only the tick-consumed pairs and warm-starts
    the non-key ones (there is no backend on which it falls back to all
    frame pairs)."""
    from videoquery.core.config import ExtractionConfig
    from videoquery.nn.tsn import TwoStreamTSN
    from videoquery.pipeline.extract import Extractor

    ex = Extractor(TwoStreamTSN.random(jax.random.PRNGKey(0), splits=(1,)),
                   ExtractionConfig())
    _ticks, _tdev, stack_dev, pair_dev, warm = ex._plan_arrays(150)
    pairs = np.asarray(pair_dev)
    assert 0 < len(pairs) < 149
    assert int(np.asarray(stack_dev).max()) == len(pairs) - 1
    key_pos, warm_pos, _src = (np.asarray(a) for a in warm)
    assert len(key_pos) + len(warm_pos) == len(pairs)
    assert len(warm_pos) > len(key_pos)


@pytest.mark.parametrize("hw,div,want", [((256, 340), 2, (128, 170)),
                                         ((240, 320), 2, (120, 160)),
                                         ((480, 854), 4, (120, 213))])
def test_flow_grid_shape_divides_each_axis(hw, div, want):
    from videoquery.pipeline.payload import flow_grid_shape

    assert flow_grid_shape(*hw, div) == want
    assert flow_grid_shape(*hw, 1) == hw


def test_warm_start_flow_recovers_translation(rng):
    """Temporal warm start: pairs refined at the finest level only from a
    neighbor pair's solution must recover the same constant translation the
    cold full-pyramid path does."""
    from videoquery.kernels.tvl1 import tvl1_flow, tvl1_flow_warm
    from videoquery.pipeline.extract import warm_tvl1_params

    h, w = 64, 128
    img = make_texture(rng, h, w)
    # constant velocity (2, -1) px/frame via repeated bilinear warps (the
    # fixture style of test_full_pyramid_flow, which the cold solver is
    # known to converge on)
    fl = (2.0 * jnp.ones((h, w)), -1.0 * jnp.ones((h, w)))
    frames = [img]
    for _ in range(3):
        frames.append(bilinear_warp(frames[-1], *fl))
    i0 = jnp.stack(frames[:-1])
    i1 = jnp.stack(frames[1:])
    p = TVL1Params(n_scales=3, n_warps=4, n_iters=25)
    uc, vc = tvl1_flow(i0[:1], i1[:1], p)  # cold key
    uw, vw = tvl1_flow_warm(
        i0[1:], i1[1:],
        jnp.broadcast_to(uc, (2, h, w)), jnp.broadcast_to(vc, (2, h, w)),
        warm_tvl1_params(p), levels=1)
    ucold, vcold = tvl1_flow(i0[1:], i1[1:], p)
    interior = (slice(None), slice(12, -12), slice(12, -12))
    # true flow is (-2, +1); the ultra-smooth fixture under-converges both
    # paths equally — the normative check is warm == cold, below
    assert abs(float(jnp.median(uw[interior])) + 2.0) < 1.3
    assert abs(float(jnp.median(vw[interior])) - 1.0) < 0.8
    # warm result tracks the cold solution of the SAME pairs closely
    assert abs(float(jnp.median(uw[interior]))
               - float(jnp.median(ucold[interior]))) < 0.25
    assert abs(float(jnp.median(vw[interior]))
               - float(jnp.median(vcold[interior]))) < 0.25


def test_pair_flow_warm_plan_matches_cold_quantized(rng):
    """_pair_flow with a warm plan must produce flow quantized within one
    dense_flow step of the cold path on smooth synthetic motion, with the
    scatter restoring pair order exactly."""
    from videoquery.pipeline.extract import _pair_flow
    from videoquery.pipeline.sampling import flow_pair_plan, flow_warm_plan

    h, w = 40, 128
    img = make_texture(rng, h, w)
    fl = (1.5 * jnp.ones((h, w)), -0.75 * jnp.ones((h, w)))
    frames = [img]
    for _ in range(11):
        frames.append(bilinear_warp(frames[-1], *fl))
    gray = jnp.stack(frames)[None]                      # [1, 12, h, w]
    pair_idx, _ = flow_pair_plan(12, 4, 5)
    plan = flow_warm_plan(pair_idx, 5)
    assert plan[1].size > 0
    p = TVL1Params(n_scales=2, n_warps=2, n_iters=8, fine_warps=2,
                   fine_iters=8)
    pj = jnp.asarray(pair_idx, jnp.int32)
    cold = np.asarray(_pair_flow(gray, pj, 20.0, False, p, (1.0, 1.0)))
    warm = np.asarray(_pair_flow(
        gray, pj, 20.0, False, p, (1.0, 1.0),
        tuple(jnp.asarray(a) for a in plan)))
    assert warm.shape == cold.shape
    interior = (slice(None), slice(None), slice(8, -8), slice(8, -8))
    diff = np.abs(warm[interior].astype(int) - cold[interior].astype(int))
    assert np.median(diff) <= 1.0  # within one 8-bit flow quantization step


def test_flow_warm_plan_structure():
    """flow_warm_plan covers every pair exactly once, keys within each run,
    and every warm pair maps to a key at most `group` frames away."""
    from videoquery.pipeline.sampling import flow_pair_plan, flow_warm_plan

    for frame_cnt, ticks in [(150, 25), (30, 25), (12, 4), (150, 4)]:
        pair_idx, _ = flow_pair_plan(frame_cnt, ticks, 5)
        for group in (2, 3, 5):
            key_pos, warm_pos, warm_src = flow_warm_plan(pair_idx, group)
            allpos = np.concatenate([key_pos, warm_pos])
            assert sorted(allpos.tolist()) == list(range(len(pair_idx))), \
                (frame_cnt, ticks, group)
            assert len(warm_src) == len(warm_pos)
            for wp, ws in zip(warm_pos, warm_src):
                kp = key_pos[ws]
                assert abs(int(pair_idx[wp]) - int(pair_idx[kp])) <= group
                # key and warm pair belong to the same consecutive run
                lo, hi = min(kp, wp), max(kp, wp)
                seg = pair_idx[lo:hi + 1]
                assert np.all(np.diff(seg) == 1)


def test_warm_tvl1_params_iteration_budget():
    """The warm refinement schedule must honor warm_iters exactly, even
    above the inherited fine_iters (iters_at_level would otherwise clamp
    a sweep's warm_iters=15 silently back to fine_iters=10)."""
    from videoquery.pipeline.extract import warm_tvl1_params

    for wi in (6, 10, 15):  # below, at, and above fine_iters
        p = warm_tvl1_params(TVL1Params(n_iters=20, fine_iters=10,
                                        warm_iters=wi))
        assert p.n_warps == 1 and p.fine_warps == 1
        assert p.iters_at_level(0) == wi, wi
    # no warm_iters set: fall back to the fine-level budget
    p = warm_tvl1_params(TVL1Params(n_iters=20, fine_iters=10))
    assert p.iters_at_level(0) == 10


def test_warm_camera_key_matches_own_on_constant_pan(rng):
    """warm_camera='key' reuses the keyframe's camera affine; on constant
    camera motion it must produce the same flow as per-pair estimation."""
    from videoquery.pipeline.extract import _pair_flow_uv
    from videoquery.pipeline.sampling import flow_warm_plan

    gray = _pan_frames(rng, 8)[None]          # constant pan (2, 3) px/frame
    pair_idx = np.arange(7, dtype=np.int32)
    plan = tuple(jnp.asarray(a) for a in flow_warm_plan(pair_idx, 3))
    p = TVL1Params(n_scales=2, n_warps=2, n_iters=8)
    u_own, v_own = _pair_flow_uv(gray, jnp.asarray(pair_idx), True, p,
                                 plan, "own")
    u_key, v_key = _pair_flow_uv(gray, jnp.asarray(pair_idx), True, p,
                                 plan, "key")
    interior = (slice(None), slice(None), slice(10, -10), slice(10, -10))
    assert float(jnp.median(jnp.abs(u_key[interior] - u_own[interior]))) < 0.15
    assert float(jnp.median(jnp.abs(v_key[interior] - v_own[interior]))) < 0.15
