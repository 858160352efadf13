"""Pyramidal TV-L1 optical flow (Zach et al. 2007) as a batched JAX program.

The GPU replacement for dense_flow's `extract_warp_gpu` CUDA binary
(shelled at reference build_wof_clips.py:70-73 with bound 20, warped TV-L1).
It has the same shape as dense_flow's OpenCV CUDA solver: I1 and its
gradients are bilinearly sampled once per warp (exact gathers, no
displacement clamp), then each primal-dual iteration is pure stencil math —
elementwise ops + 4-point neighbor differences — which XLA fuses into a
handful of kernels per iteration. Frame pairs are batched on the leading
axis so a whole clip batch's flow computes as one program.

The warped variant estimates global camera motion (videoquery.kernels.motion)
on a coarse grid, warps the second frame to cancel it, and runs TV-L1 on
the compensated pair — the same two-pass structure dense_flow uses with its
homography-of-SURF-matches estimate.

Warm start (the production schedule, pipeline/extract.py): a pair next to
an already-solved keyframe pair refines the key's flow at the finest
pyramid level only (tvl1_flow_warm), and may reuse or refine the key's
camera instead of estimating its own (tvl1_warped_flow_warm).

Default parameters follow OpenCV's DualTVL1 (tau 0.25, theta 0.3,
5 scales, 5 warps, 30 inner iterations), which is what dense_flow wraps;
lambda is OpenCV's 0.15 re-expressed for unit-scale intensities
(0.15 x 255 — see the field comment).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from videoquery.kernels.motion import (affine_to_native_coords,
                                       affine_to_warp)
from videoquery.kernels.warp import bilinear_sample, warp_affine


@dataclasses.dataclass(frozen=True)
class TVL1Params:
    tau: float = 0.25           # dual time step
    # Data attachment weight, INTENSITY-SCALE-CORRECTED (round 4). The
    # classical value 0.15 (IPOL/OpenCV, what dense_flow ran) assumes
    # 8-bit [0, 255] images; this pipeline feeds [0, 1] gray, where the
    # TV-L1 prox threshold lambda*theta*|grad I|^2 scales with intensity^2
    # — at lambda=0.15 the data term was ~255x weaker than the
    # reference's, and the solver recovered only ~0.7 px of ANY rigid
    # shift on realistic-contrast textures (a pure 3 px roll solved to
    # 0.46 px). 0.15 * 255 = 38.25 reproduces OpenCV's balance exactly:
    # rigid shifts 1-8 px now solve to <=0.14 px mean error at the
    # production schedule (tools/flow_quality.py corpus v3).
    lambda_: float = 38.25
    theta: float = 0.3          # tightness
    n_scales: int = 5
    n_warps: int = 5
    n_iters: int = 30           # primal-dual iterations per warp
    scale_step: float = 0.5
    grad_eps: float = 1e-6
    # Warp passes at the finest 2 pyramid levels (None = n_warps). Fine
    # levels hold 4x/16x the pixels of the coarse ones while the coarse
    # levels have already converged the large motion.
    fine_warps: int | None = None
    # Primal-dual iterations at the finest 2 pyramid levels (None = n_iters).
    # Fine levels start from an already-converged upsampled coarse flow, so
    # they need fewer iterations; the inner loop is the hot path.
    fine_iters: int | None = None
    # Primal-dual iterations for a WARM-started pair's single refinement
    # warp (None = fine_iters): the init flow already carries a converged
    # neighbor solution, so the residual solve can use fewer iterations
    # than a cold fine level. Sweep with tools/flow_quality.py --warm_iters
    # (EPE + retrieval gated) before changing in production.
    warm_iters: int | None = None
    # Warp passes for a warm-started pair's refinement (finest level only).
    # 1 ships; 2 re-linearizes once more — sweep with
    # tools/flow_quality.py --warm_iters under the corrected lambda.
    warm_warps: int = 1
    # Coarse grid for the camera-motion estimation pass of the warped
    # variant. The handful of global parameters need far fewer samples than
    # the flow grid; (48, 64) scored >= (64, 96) on the 3-seed
    # production-scale retrieval gate while (32, 48) cliffs
    # (tools/flow_quality.py --res_sweep) — heights below ~48
    # under-resolve the pan classes.
    coarse_hw: tuple[int, int] = (48, 64)
    # Camera-motion model for the warped variant: "affine" (6-param LK fit;
    # pan + zoom + rotation/shear) or "homography" (8 params — adds the two
    # perspective columns, matching dense_flow's SURF+RANSAC homography
    # model, build_wof_clips.py:70-73). Gate with tools/flow_quality.py's
    # perspective classes before switching production.
    camera_model: str = "affine"

    def warps_at_level(self, level: int) -> int:
        if self.fine_warps is not None and level < 2:
            return min(self.n_warps, self.fine_warps)
        return self.n_warps

    def iters_at_level(self, level: int) -> int:
        if self.fine_iters is not None and level < 2:
            return min(self.n_iters, self.fine_iters)
        return self.n_iters

    def at_level(self, level: int) -> "TVL1Params":
        return dataclasses.replace(self, n_warps=self.warps_at_level(level),
                                   n_iters=self.iters_at_level(level))


def _forward_diff(f: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Forward differences with Neumann boundary (zero at far edge)."""
    fx = jnp.concatenate([f[:, 1:] - f[:, :-1], jnp.zeros_like(f[:, :1])], axis=1)
    fy = jnp.concatenate([f[1:, :] - f[:-1, :], jnp.zeros_like(f[:1, :])], axis=0)
    return fx, fy


def _divergence(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """Adjoint of -forward_diff: backward differences with the standard
    boundary handling (first element kept, last negated)."""
    d1 = jnp.concatenate([p1[:, :1], p1[:, 1:-1] - p1[:, :-2], -p1[:, -2:-1]], axis=1)
    d2 = jnp.concatenate([p2[:1, :], p2[1:-1, :] - p2[:-2, :], -p2[-2:-1, :]], axis=0)
    return d1 + d2


def _centered_grad(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    gx = (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1)) * 0.5
    gx = gx.at[:, 0].set(img[:, 1] - img[:, 0]).at[:, -1].set(img[:, -1] - img[:, -2])
    gy = (jnp.roll(img, -1, axis=0) - jnp.roll(img, 1, axis=0)) * 0.5
    gy = gy.at[0, :].set(img[1] - img[0]).at[-1, :].set(img[-1] - img[-2])
    return gx, gy


def _grid(h: int, w: int):
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    return ys, xs


def _tvl1_level(I0, I1, u, v, p: TVL1Params):
    """One pyramid level: n_warps x n_iters primal-dual updates. All inputs
    [H, W]; returns updated (u, v)."""
    h, w = I0.shape
    ys, xs = _grid(h, w)
    I1x, I1y = _centered_grad(I1)
    l_t = p.lambda_ * p.theta
    taut = p.tau / p.theta

    def warp_pass(carry, _):
        u0, v0, p11, p12, p21, p22 = carry
        # warp I1 and its gradient by the current flow estimate
        wy, wx = ys + v0, xs + u0
        I1w = bilinear_sample(I1, wy, wx)
        I1wx = bilinear_sample(I1x, wy, wx)
        I1wy = bilinear_sample(I1y, wy, wx)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u0 - I1wy * v0 - I0

        def inner(carry2, _):
            u_, v_, q11, q12, q21, q22 = carry2
            rho = rho_c + I1wx * u_ + I1wy * v_
            th = l_t * grad
            # soft thresholding of the data term
            d_lt = jnp.where(rho < -th, l_t, 0.0)
            d_gt = jnp.where(rho > th, -l_t, 0.0)
            mid = jnp.where((rho >= -th) & (rho <= th),
                            -rho / jnp.maximum(grad, p.grad_eps), 0.0)
            step = d_lt + d_gt + mid
            u1 = u_ + step * I1wx
            v1 = v_ + step * I1wy
            # primal update with divergence of the dual field
            un = u1 + p.theta * _divergence(q11, q12)
            vn = v1 + p.theta * _divergence(q21, q22)
            # dual ascent
            ux, uy = _forward_diff(un)
            vx, vy = _forward_diff(vn)
            gu = jnp.sqrt(ux * ux + uy * uy)
            gv = jnp.sqrt(vx * vx + vy * vy)
            q11 = (q11 + taut * ux) / (1.0 + taut * gu)
            q12 = (q12 + taut * uy) / (1.0 + taut * gu)
            q21 = (q21 + taut * vx) / (1.0 + taut * gv)
            q22 = (q22 + taut * vy) / (1.0 + taut * gv)
            return (un, vn, q11, q12, q21, q22), None

        (u1, v1, p11, p12, p21, p22), _ = jax.lax.scan(
            inner, (u0, v0, p11, p12, p21, p22), None, length=p.n_iters
        )
        return (u1, v1, p11, p12, p21, p22), None

    zeros = jnp.zeros_like(u)
    (u, v, *_), _ = jax.lax.scan(
        warp_pass, (u, v, zeros, zeros, zeros, zeros), None, length=p.n_warps
    )
    return u, v


def _pyramid_shapes(h: int, w: int, p: TVL1Params) -> list[tuple[int, int]]:
    shapes = [(h, w)]
    for _ in range(p.n_scales - 1):
        h = max(int(round(h * p.scale_step)), 16)
        w = max(int(round(w * p.scale_step)), 16)
        if (h, w) == shapes[-1]:
            break
        shapes.append((h, w))
    return shapes


def _resize2(img: jax.Array, hw: tuple[int, int]) -> jax.Array:
    return jax.image.resize(img, hw, method="linear")


def _tvl1_single(I0: jax.Array, I1: jax.Array, p: TVL1Params,
                 u0: jax.Array | None = None, v0: jax.Array | None = None,
                 levels: int | None = None):
    """Pyramidal flow for one [H, W] pair; images scaled to [0, 1].

    Cold (u0 None): the whole pyramid, from zero flow at the coarsest
    level. Warm: only the finest `levels` levels, starting from (u0, v0)
    given at full resolution in full-resolution pixels."""
    shapes = _pyramid_shapes(*I0.shape, p)
    if levels is not None:
        shapes = shapes[:levels]
    pyr0 = [I0] + [None] * (len(shapes) - 1)
    pyr1 = [I1] + [None] * (len(shapes) - 1)
    for i in range(1, len(shapes)):
        pyr0[i] = _resize2(pyr0[i - 1], shapes[i])
        pyr1[i] = _resize2(pyr1[i - 1], shapes[i])
    if u0 is None:
        u = jnp.zeros(shapes[-1], jnp.float32)
        v = jnp.zeros(shapes[-1], jnp.float32)
    elif len(shapes) == 1:
        u, v = u0, v0
    else:
        scale = p.scale_step ** (len(shapes) - 1)
        u = _resize2(u0, shapes[-1]) * scale
        v = _resize2(v0, shapes[-1]) * scale
    for i in reversed(range(len(shapes))):
        u, v = _tvl1_level(pyr0[i], pyr1[i], u, v, p.at_level(i))
        if i > 0:
            inv = 1.0 / p.scale_step
            u = _resize2(u, shapes[i - 1]) * inv
            v = _resize2(v, shapes[i - 1]) * inv
    return u, v


@functools.partial(jax.jit, static_argnames=("params",))
def tvl1_flow(
    I0: jax.Array,  # [B, H, W] grayscale in [0, 1]
    I1: jax.Array,
    params: TVL1Params = TVL1Params(),
) -> tuple[jax.Array, jax.Array]:
    """Batched TV-L1 flow: returns (u, v) each [B, H, W] in pixels."""
    return jax.vmap(lambda a, b: _tvl1_single(a, b, params))(I0, I1)


@functools.partial(jax.jit, static_argnames=("params", "levels"))
def tvl1_flow_warm(
    I0: jax.Array,  # [B, H, W] grayscale in [0, 1]
    I1: jax.Array,
    u0: jax.Array,  # [B, H, W] initial flow (e.g. a neighbor pair's)
    v0: jax.Array,
    params: TVL1Params = TVL1Params(),
    levels: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Warm-started TV-L1: refine an initial flow running only the finest
    `levels` pyramid levels. Consecutive pairs have highly correlated flow,
    so the coarse pyramid that exists to recover LARGE motion from zero is
    redundant when initialized from a neighbor's solution."""
    return jax.vmap(lambda a, b, c, d: _tvl1_single(a, b, params, c, d,
                                                    levels))(I0, I1, u0, v0)


def _resize_batch(img: jax.Array, hw: tuple[int, int]) -> jax.Array:
    return jax.image.resize(img, img.shape[:-2] + tuple(hw), method="linear")


def _gather_warp(img: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    """Batched exact bilinear warp: out[n](y, x) = img[n](y + v, x + u)."""
    ys, xs = _grid(*img.shape[-2:])
    return jax.vmap(lambda im, uu, vv: bilinear_sample(im, ys + vv, xs + uu))(
        img, u, v)


def estimate_camera(I0: jax.Array, I1: jax.Array, p: TVL1Params) -> jax.Array:
    """Per-pair global camera motion on the p.coarse_hw grid (apply with
    apply_camera):
    p.camera_model == "affine"     -> A [N, 2, 3] displacement affine in
                                      I0's pixel coords;
    p.camera_model == "homography" -> Hn [N, 3, 3] normalized-coords
                                      homography (8 params — dense_flow's
                                      model class, build_wof_clips.py:70-73).

    Integer translation from one cross-correlation (robust to pans of ANY
    size up to the correlation window) + direct parametric (Lucas-Kanade)
    refinement on the translation-compensated coarse pair. A
    TV-L1-flow-then-affine-fit estimator was abandoned: the TV prior
    FLATTENS divergent fields, so a camera zoom came back at <10% magnitude
    and stayed uncompensated (dense_flow avoids the same trap by fitting
    its homography to feature matches, not regularized flow)."""
    from videoquery.kernels.motion import (global_translation,
                                           homography_translate,
                                           lk_affine_batch,
                                           lk_homography_batch)

    ch, cw = p.coarse_hw
    c0 = _resize_batch(I0, p.coarse_hw)
    c1 = _resize_batch(I1, p.coarse_hw)
    t = global_translation(c0, c1, max_shift=12)          # i32 [N, 2] (u, v)

    def roll_one(im, ti):
        # compensate: sample c1 at x + t  ==  roll contents left/up by t
        return jnp.roll(jnp.roll(im, -ti[1], axis=0), -ti[0], axis=1)

    c1t = jax.vmap(roll_one)(c1, t)
    tx = t[:, 0].astype(jnp.float32)
    ty = t[:, 1].astype(jnp.float32)
    if p.camera_model == "homography":
        Hn = lk_homography_batch(c0, c1t, n_iters=6)
        # fold the integer pre-translation in (normalized coords are
        # resolution-independent: Hn applies on ANY grid of the same FoV)
        return homography_translate(Hn, tx, ty, cw, ch)
    A = lk_affine_batch(c0, c1t, n_iters=6)
    # add the integer translation, scale VALUES (coarse px -> native px per
    # axis), then convert the fit's coarse COORDS to native coords
    A = A.at[:, 0, 2].add(tx).at[:, 1, 2].add(ty)
    sx = I0.shape[2] / cw
    sy = I0.shape[1] / ch
    A = A * jnp.asarray([sx, sy])[:, None]
    return affine_to_native_coords(A, sx, sy)


def refine_camera(I0: jax.Array, I1: jax.Array, p: TVL1Params,
                  Hn0: jax.Array, n_iters: int = 3) -> jax.Array:
    """Refine a NEIGHBOR pair's camera homography Hn0 [N, 3, 3] on this
    pair: no translation pre-pass, LK warm-started at Hn0's parameters —
    the middle ground between reusing the key's camera verbatim (stale on
    handheld jitter) and a full per-pair estimate (translation correlation
    + 6 LK iterations). The LK warp is an exact gather, so any pan size
    is reachable."""
    from videoquery.kernels.motion import (homography_params,
                                           lk_homography_batch)

    c0 = _resize_batch(I0, p.coarse_hw)
    c1 = _resize_batch(I1, p.coarse_hw)
    return lk_homography_batch(c0, c1, n_iters=n_iters,
                               p0=homography_params(Hn0))


def apply_camera(I1: jax.Array, A: jax.Array) -> jax.Array:
    """Warp I1 [N, H, W] to cancel the camera motion: A [N, 2, 3] =
    displacement affine in I1's coords; [N, 3, 3] = normalized-coords
    homography."""
    h, w = I1.shape[1:]
    if A.shape[-2] == 3:
        from videoquery.kernels.motion import homography_displacement

        du, dv = homography_displacement(A, h, w)
        return _gather_warp(I1, du, dv)
    return jax.vmap(lambda im, a: warp_affine(im, affine_to_warp(a, h, w)))(
        I1, A)


@functools.partial(jax.jit, static_argnames=("params",))
def tvl1_warped_flow_cam(
    I0: jax.Array,  # [B, H, W] grayscale in [0, 1]
    I1: jax.Array,
    params: TVL1Params = TVL1Params(),
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """tvl1_warped_flow that also returns the per-pair camera estimate
    (estimate_camera), so warm-started neighbor pairs can reuse it."""
    A = estimate_camera(I0, I1, params)
    u, v = tvl1_flow(I0, apply_camera(I1, A), params)
    return u, v, A


@functools.partial(jax.jit, static_argnames=("params",))
def tvl1_warped_flow(
    I0: jax.Array,  # [B, H, W] grayscale in [0, 1]
    I1: jax.Array,
    params: TVL1Params = TVL1Params(),
) -> tuple[jax.Array, jax.Array]:
    """Warped TV-L1: cancel global camera motion, then compute flow — the
    two-pass structure of dense_flow's extract_warp_gpu. The returned flow
    is the residual (foreground) motion, as in the reference."""
    u, v, _ = tvl1_warped_flow_cam(I0, I1, params)
    return u, v


@functools.partial(jax.jit,
                   static_argnames=("params", "levels", "cam_refine_iters"))
def tvl1_warped_flow_warm(
    I0: jax.Array,
    I1: jax.Array,
    u0: jax.Array,
    v0: jax.Array,
    params: TVL1Params = TVL1Params(),
    levels: int = 1,
    A: jax.Array | None = None,
    cam_refine_iters: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Warm-started warped variant. By default each pair still gets its OWN
    camera estimate (camera motion changes per pair); only the
    residual-flow solve is warm-started from the neighbor's residual.
    Passing A (the keyframe pair's estimate) skips the estimation and
    reuses it; with cam_refine_iters > 0 and a homography A, the key's
    estimate is instead REFINED on this pair with that many warm-started
    LK iterations (ExtractionConfig.flow_warm_camera="init")."""
    if A is None:
        A = estimate_camera(I0, I1, params)
    elif cam_refine_iters > 0 and A.shape[-2] == 3:
        A = refine_camera(I0, I1, params, A, n_iters=cam_refine_iters)
    return tvl1_flow_warm(I0, apply_camera(I1, A), u0, v0, params,
                          levels=levels)
