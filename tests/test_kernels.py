"""TV-L1 flow, warping, and global-motion estimation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from videoquery.kernels.motion import affine_to_warp, estimate_affine
from videoquery.kernels.tvl1 import TVL1Params, tvl1_flow, tvl1_warped_flow
from videoquery.kernels.warp import bilinear_warp, warp_affine


def make_texture(rng, h=96, w=128):
    """Smooth random texture (flow needs gradients everywhere)."""
    base = rng.normal(size=(h // 8, w // 8))
    import jax.image

    img = jax.image.resize(jnp.asarray(base), (h, w), "cubic")
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(jnp.float32)


def shift_image(img, dx, dy):
    """Shift by integer pixels with edge clamp (ground-truth motion)."""
    return bilinear_warp(img, -dx * jnp.ones_like(img), -dy * jnp.ones_like(img))


def test_bilinear_warp_identity(rng):
    img = make_texture(rng)
    z = jnp.zeros_like(img)
    np.testing.assert_allclose(np.asarray(bilinear_warp(img, z, z)),
                               np.asarray(img), atol=1e-6)


def test_warp_affine_matches_translation(rng):
    img = make_texture(rng)
    A = jnp.asarray([[1.0, 0.0, 3.0], [0.0, 1.0, -2.0]])
    got = np.asarray(warp_affine(img, A))
    want = np.asarray(bilinear_warp(img, 3.0 * jnp.ones_like(img),
                                    -2.0 * jnp.ones_like(img)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tvl1_recovers_translation(rng):
    """A pure 2px translation must be recovered to subpixel accuracy in the
    interior."""
    img = make_texture(rng)
    dx, dy = 2.0, 1.0
    moved = shift_image(img, dx, dy)
    u, v = tvl1_flow(img[None], moved[None],
                     TVL1Params(n_scales=4, n_warps=5, n_iters=30))
    interior = (slice(0, 1), slice(16, -16), slice(16, -16))
    assert abs(np.median(np.asarray(u)[interior]) - dx) < 0.35
    assert abs(np.median(np.asarray(v)[interior]) - dy) < 0.35


def test_estimate_affine_recovers_global_translation(rng):
    h, w = 64, 96
    u = np.full((h, w), 3.0, np.float32)
    v = np.full((h, w), -1.5, np.float32)
    # 20% outliers from a "foreground object"
    u[20:35, 30:50] = -8.0
    v[20:35, 30:50] = 6.0
    A = np.asarray(estimate_affine(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(A[:, :2], 0.0, atol=0.05)
    assert abs(A[0, 2] - 3.0) < 0.3
    assert abs(A[1, 2] + 1.5) < 0.3


def test_estimate_affine_recovers_zoom(rng):
    h, w = 64, 96
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy, s = w / 2, h / 2, 0.02
    u = (xs - cx) * s
    v = (ys - cy) * s
    A = np.asarray(estimate_affine(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(A[0, 0], s, atol=0.004)
    np.testing.assert_allclose(A[1, 1], s, atol=0.004)


def test_warped_flow_cancels_camera_motion(rng):
    """Global pan: residual (warped) flow should be ~0 while plain TV-L1
    sees the pan."""
    img = make_texture(rng)
    moved = shift_image(img, 4.0, 0.0)
    u_plain, _ = tvl1_flow(img[None], moved[None],
                           TVL1Params(n_scales=4, n_warps=4, n_iters=20))
    u_warp, v_warp = tvl1_warped_flow(img[None], moved[None],
                                      TVL1Params(n_scales=4, n_warps=4, n_iters=20))
    interior = (slice(0, 1), slice(16, -16), slice(16, -16))
    plain_mag = np.median(np.abs(np.asarray(u_plain)[interior]))
    warp_mag = np.median(np.abs(np.asarray(u_warp)[interior]))
    assert plain_mag > 2.0          # plain flow sees the pan
    assert warp_mag < 0.5 * plain_mag  # warped flow mostly cancels it


def test_flow_quantization_roundtrip(rng):
    from videoquery.pipeline.preprocess import dequantize_flow, quantize_flow

    f = jnp.asarray(rng.uniform(-25, 25, (16, 16)), jnp.float32)
    q = quantize_flow(f, bound=20.0)
    assert q.dtype == jnp.uint8
    back = np.asarray(dequantize_flow(q, bound=20.0))
    np.testing.assert_allclose(back, np.clip(np.asarray(f), -20, 20), atol=0.08)


def test_tick_sampling_reference_semantics():
    from videoquery.pipeline.sampling import flow_stack_indices, frame_ticks

    # 150-frame clip (10 s @ 15 fps): rgb ticks 1,7,...,145
    t = frame_ticks(150, 25, stack_depth=1)
    assert len(t) == 25 and t[0] == 1 and t[1] == 7 and t[-1] == 145
    # flow with stack depth 5: same step (floor((150-5)/24) = 6)
    t5 = frame_ticks(150, 25, stack_depth=5)
    assert len(t5) == 25 and t5[-1] == 145
    # short clip: all ones
    t_short = frame_ticks(20, 25, stack_depth=5)
    assert (t_short == 1).all()
    # flow stack indices clamp at the clip end
    np.testing.assert_array_equal(flow_stack_indices(148, 150, 5),
                                  [148, 149, 150, 150, 150])


def test_clip_ranges_reference_semantics():
    from videoquery.pipeline.sampling import clip_ranges

    # 380 frames @ 15fps, 10s clips: 2 full clips + 80-frame (5.3s) tail
    r = clip_ranges(380, fps=15, clip_seconds=10)
    assert r == [(1, 150), (151, 300), (301, 380)]
    # tail under 2 s is dropped
    r = clip_ranges(320, fps=15, clip_seconds=10)
    assert r == [(1, 150), (151, 300)]
    # exactly 2 s tail is kept
    r = clip_ranges(330, fps=15, clip_seconds=10)
    assert r == [(1, 150), (151, 300), (301, 330)]


def test_camera_zoom_compensation(rng):
    """A pure camera ZOOM must be (mostly) cancelled by the affine
    compensation — regression test for the coarse-vs-native coordinate
    mismatch where the fit's linear terms were applied unscaled at native
    coordinates, over-compensating zoom/rotation by W_native/W_coarse (the
    translation-only quality corpus could never see it)."""
    from videoquery.kernels.tvl1 import TVL1Params, tvl1_flow, tvl1_warped_flow
    from videoquery.kernels.warp import warp_affine

    h, w = 96, 128
    base = jnp.asarray(rng.normal(size=(h // 8, w // 8)))
    img = jax.image.resize(base, (h, w), "cubic").astype(jnp.float32)
    img = (img - img.min()) / (img.max() - img.min())
    z = 0.02  # 2% zoom-in about the center
    cx, cy = (w - 1) / 2, (h - 1) / 2
    A = jnp.asarray([[1 - z, 0, z * cx], [0, 1 - z, z * cy]])
    i1 = warp_affine(img, A)
    p = TVL1Params(n_scales=3, n_warps=3, n_iters=20)
    interior = (slice(None), slice(12, -12), slice(12, -12))

    u, v = tvl1_warped_flow(img[None], i1[None], p)
    residual = jnp.sqrt(u**2 + v**2)[interior]
    ur, vr = tvl1_flow(img[None], i1[None], p)
    raw = jnp.sqrt(ur**2 + vr**2)[interior]

    assert float(jnp.median(residual)) < 0.25
    # compensation must remove most of the zoom field, not amplify/invert it
    assert float(jnp.median(residual)) < 0.45 * float(jnp.median(raw))
