"""Homography (8-param) camera model — VERDICT r3 #5.

dense_flow compensates camera motion with a SURF+RANSAC homography
(build_wof_clips.py:70-73); the affine LK fit covers pan/zoom/rotation
but not perspective. These tests check the projective extension: the fit
recovers synthetic perspective warps (>= 90%), reduces exactly to the
affine behavior on affine scenes, and the end-to-end warped flow cancels
a perspective camera motion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from videoquery.kernels.motion import (
    homography_displacement,
    homography_translate,
    lk_homography_batch,
)
from videoquery.kernels.tvl1 import TVL1Params


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def smooth_texture(rng, h, w):
    base = jnp.asarray(rng.normal(size=(h // 8, w // 8)))
    img = jax.image.resize(base, (h, w), "cubic").astype(jnp.float32)
    return (img - img.min()) / (img.max() - img.min())


def warp_by_homography(img, Hn):
    """Ground-truth warp: sample img at x + disp(Hn) with exact bilinear
    gathers (test-side only)."""
    from videoquery.kernels.warp import bilinear_sample

    h, w = img.shape
    u, v = homography_displacement(Hn[None], h, w)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    return bilinear_sample(img, ys + v[0], xs + u[0])


def make_persp(p6=0.0, p7=0.0, tx=0.0, ty=0.0):
    Hn = jnp.eye(3)
    Hn = Hn.at[2, 0].set(p6).at[2, 1].set(p7)
    Hn = Hn.at[0, 2].set(tx).at[1, 2].set(ty)
    return Hn


def test_homography_displacement_resolution_independent():
    Hn = make_persp(p6=0.05, tx=0.01)[None]
    u1, v1 = homography_displacement(Hn, 64, 96)
    u2, v2 = homography_displacement(Hn, 128, 192)
    # same normalized field -> pixel values scale with resolution
    np.testing.assert_allclose(np.asarray(u2[0, ::2, ::2]) / 2.0,
                               np.asarray(u1[0]), atol=0.05)
    np.testing.assert_allclose(np.asarray(v2[0, ::2, ::2]) / 2.0,
                               np.asarray(v1[0]), atol=0.05)


def test_homography_translate_is_pixel_shift():
    h, w = 64, 96
    Hn = homography_translate(jnp.eye(3)[None], jnp.asarray([3.0]),
                              jnp.asarray([-2.0]), w, h)
    u, v = homography_displacement(Hn, h, w)
    np.testing.assert_allclose(np.asarray(u), 3.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v), -2.0, atol=1e-5)
    # and on a perspective matrix the shift stays constant in pixels
    Hp = homography_translate(make_persp(p6=0.1)[None], jnp.asarray([3.0]),
                              jnp.asarray([0.0]), w, h)
    u0, _ = homography_displacement(make_persp(p6=0.1)[None], h, w)
    u1, _ = homography_displacement(Hp, h, w)
    np.testing.assert_allclose(np.asarray(u1 - u0), 3.0, atol=1e-5)


def test_lk_homography_recovers_perspective(rng):
    """>= 90% recovery of a pure perspective warp (the VERDICT gate)."""
    h, w = 96, 128
    img = smooth_texture(rng, h, w)
    for p6, p7 in ((0.06, 0.0), (0.0, 0.05), (0.04, -0.03)):
        Hn_true = make_persp(p6=p6, p7=p7)
        i1 = warp_by_homography(img, Hn_true)
        Hn = lk_homography_batch(img[None], i1[None], n_iters=10)
        got6 = float(Hn[0, 2, 0])
        got7 = float(Hn[0, 2, 1])
        # the fit estimates the warp that maps i1 BACK onto img — the
        # INVERSE of the generating homography (what compensation applies);
        # for a pure-perspective Hn_true the inverse negates p6/p7 exactly
        if p6:
            assert abs(got6 + p6) < 0.1 * abs(p6) + 0.004, (got6, p6)
        if p7:
            assert abs(got7 + p7) < 0.1 * abs(p7) + 0.004, (got7, p7)


def test_lk_homography_matches_affine_on_zoom(rng):
    """On an affine scene the two extra columns must stay ~0 and the zoom
    recovery must match the affine fit's."""
    from videoquery.kernels.motion import lk_affine_batch

    h, w = 96, 128
    img = smooth_texture(rng, h, w)
    z = 0.02
    Hn_zoom = jnp.eye(3).at[0, 0].set(1 - z).at[1, 1].set(1 - z)
    i1 = warp_by_homography(img, Hn_zoom)
    Hn = lk_homography_batch(img[None], i1[None], n_iters=10)
    A = lk_affine_batch(img[None], i1[None], n_iters=10)
    # perspective terms vanish
    assert abs(float(Hn[0, 2, 0])) < 0.005
    assert abs(float(Hn[0, 2, 1])) < 0.005
    # zoom recovered like the affine fit: compare displacement fields
    uh, vh = homography_displacement(Hn, h, w)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ua = (np.asarray(A[0, 0, 0]) * xs + np.asarray(A[0, 0, 1]) * ys
          + np.asarray(A[0, 0, 2]))
    np.testing.assert_allclose(np.asarray(uh[0]), ua, atol=0.25)


def test_camera_homography_cancels_perspective(rng):
    """estimate_camera/apply_camera with camera_model='homography'
    compensates a perspective camera motion, and better than the affine
    model can."""
    from videoquery.kernels.tvl1 import apply_camera, estimate_camera

    h, w = 96, 128
    img = smooth_texture(rng, h, w)
    Hn_true = make_persp(p6=0.08, p7=0.0, tx=0.01)
    i1 = warp_by_homography(img, Hn_true)

    p_h = TVL1Params(n_scales=3, n_warps=3, n_iters=20,
                     camera_model="homography", coarse_hw=(48, 64))
    Hn = estimate_camera(img[None], i1[None], p_h)
    assert Hn.shape == (1, 3, 3)
    i1c = apply_camera(i1[None], Hn)
    p_a = TVL1Params(n_scales=3, n_warps=3, n_iters=20,
                     camera_model="affine", coarse_hw=(48, 64))
    Aaf = estimate_camera(img[None], i1[None], p_a)
    assert Aaf.shape == (1, 2, 3)
    i1a = apply_camera(i1[None], Aaf)
    # residual intensity difference after compensation << before
    interior = (slice(None), slice(12, -12), slice(12, -12))
    before = float(jnp.abs(i1 - img)[None][interior].mean())
    after = float(jnp.abs(i1c - img[None])[interior].mean())
    assert after < 0.5 * before, (after, before)
    # the affine model on the same pair leaves more residual than the
    # homography (the perspective gradient across x is inexpressible)
    after_affine = float(jnp.abs(i1a - img[None])[interior].mean())
    assert after <= after_affine * 1.05, (after, after_affine)


def test_xla_warped_flow_homography_cancels_perspective(rng):
    """Portable path: tvl1_warped_flow with camera_model='homography'
    leaves near-zero residual flow on a pure perspective camera motion
    (the analogue of test_camera_zoom_compensation)."""
    from videoquery.kernels.tvl1 import tvl1_flow, tvl1_warped_flow

    h, w = 96, 128
    img = smooth_texture(rng, h, w)
    i1 = warp_by_homography(img, make_persp(p6=0.08))
    p = TVL1Params(n_scales=3, n_warps=3, n_iters=20,
                   camera_model="homography")
    interior = (slice(None), slice(12, -12), slice(12, -12))
    u, v = tvl1_warped_flow(img[None], i1[None], p)
    residual = jnp.sqrt(u**2 + v**2)[interior]
    ur, vr = tvl1_flow(img[None], i1[None], p)
    raw = jnp.sqrt(ur**2 + vr**2)[interior]
    assert float(jnp.median(residual)) < 0.3
    assert float(jnp.median(residual)) < 0.5 * float(jnp.median(raw))
