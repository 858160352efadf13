"""Global (camera) motion estimation for warped optical flow.

dense_flow's extract_warp_gpu cancels camera motion by estimating a
homography from SURF matches + flow correspondences and warping the second
frame before the final TV-L1 pass (invoked at build_wof_clips.py:70-73; the
implementation lives in the external dense_flow C++/CUDA project).

Here: fit a global affine motion model to a coarse flow
field by iteratively reweighted least squares (robust to foreground
outliers). An affine fit on dense flow is the compiler-friendly equivalent —
no feature detection, no RANSAC branching, one small 6x6 solve — and for
camera pan/zoom/rotation it captures the same compensation. All array ops,
jit/vmap-able."""

from __future__ import annotations

import jax
import jax.numpy as jnp

# the LK normal equations are tiny reductions: keep them in full f32 on
# every backend (the GPU would otherwise round the products to TF32)
_HIGHEST = jax.lax.Precision.HIGHEST


def estimate_affine(
    flow_u: jax.Array,  # [H, W] dx at each pixel
    flow_v: jax.Array,  # [H, W] dy
    n_irls: int = 3,
    delta: float = 1.0,
) -> jax.Array:
    """Fit (u, v) ~ affine(x, y): returns the 2x3 matrix A with
    src = [x, y] + A @ [x, y, 1] being the background motion.

    IRLS with a Huber-style weight 1/max(residual, delta) downweights
    independently moving foreground objects."""
    h, w = flow_u.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0).ravel()
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1).ravel()
    # normalize coordinates for conditioning
    sx, sy = 2.0 / w, 2.0 / h
    xn = xs * sx - 1.0
    yn = ys * sy - 1.0
    ones = jnp.ones_like(xn)
    G = jnp.stack([xn, yn, ones], axis=1)            # [N, 3]
    u = flow_u.ravel()
    v = flow_v.ravel()

    def solve(weights):
        gw = G * weights[:, None]                     # [N, 3]
        gtg = G.T @ gw + 1e-6 * jnp.eye(3)
        au = jnp.linalg.solve(gtg, gw.T @ u)          # [3]
        av = jnp.linalg.solve(gtg, gw.T @ v)
        return au, av

    def body(carry, _):
        au, av = carry
        ru = G @ au - u
        rv = G @ av - v
        r = jnp.sqrt(ru * ru + rv * rv + 1e-8)
        wgt = jnp.minimum(1.0, delta / r)
        return solve(wgt), None

    init = solve(jnp.ones_like(u))
    (au, av), _ = jax.lax.scan(body, init, None, length=n_irls)
    # un-normalize: u = au0*(x*sx-1) + au1*(y*sy-1) + au2
    # NOTE: the linear terms are per-pixel-OF-THIS-GRID slopes. When the
    # fit runs on a coarse grid but the warp applies A at native
    # coordinates, rescale with affine_to_native_coords — applying raw A at
    # native coords over-compensates zoom/rotation by native/coarse.
    A = jnp.asarray([
        [au[0] * sx, au[1] * sy, au[2] - au[0] - au[1]],
        [av[0] * sx, av[1] * sy, av[2] - av[0] - av[1]],
    ])
    return A


def affine_to_native_coords(A: jax.Array, rx, ry) -> jax.Array:
    """Convert an affine fit done at coarse-grid coordinates (flow VALUES
    already in native px) to native coordinates: x_c = x_n/rx, y_c = y_n/ry
    with rx = W_native/W_coarse. Linear terms divide by the ratio; the
    translation is coordinate-free. Works for [2, 3] and batched [N, 2, 3]."""
    scale = jnp.asarray([1.0 / rx, 1.0 / ry, 1.0])
    return A * scale


def affine_to_warp(A: jax.Array, h: int, w: int) -> jax.Array:
    """2x3 background-motion matrix -> absolute source-coordinate affine for
    warp_affine: src = [x, y] + A@[x, y, 1] = (I + A_lin) @ [x, y, 1]."""
    return A + jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


estimate_affine_batch = jax.vmap(estimate_affine)


def global_translation(
    c0: jax.Array,  # [N, H, W] coarse grayscale
    c1: jax.Array,
    max_shift: int = 12,
) -> jax.Array:
    """Integer global translation per pair via zero-mean cross-correlation,
    computed as ONE depthwise convolution (robust to any pan size
    up to max_shift at this resolution — the piece iterative TV-L1 struggles
    with). Returns i32 [N, 2] (dx, dy): c1 shifted by -t aligns with c0.
    Full f32 precision: the argmax must not depend on whether the backend
    would otherwise round the products (TF32 on the GPU)."""
    n, h, w = c0.shape
    a = c0 - c0.mean(axis=(1, 2), keepdims=True)
    b = c1 - c1.mean(axis=(1, 2), keepdims=True)
    # kernel: interior of b; slide over a -> [1, N, 2m+1, 2m+1]
    m = max_shift
    kern = b[:, m:h - m, m:w - m][:, None]               # [N, 1, h-2m, w-2m]
    corr = jax.lax.conv_general_dilated(
        a[None],                                          # [1, N, H, W]
        kern,
        window_strides=(1, 1),
        padding="VALID",
        feature_group_count=n,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )[0]                                                  # [N, 2m+1, 2m+1]
    flat = corr.reshape(n, -1)
    idx = jnp.argmax(flat, axis=1)
    # correlation peak at offset (dy, dx) means b's interior matches a at
    # position (dy, dx); zero shift corresponds to (m, m)
    dy = idx // (2 * m + 1) - m
    dx = idx % (2 * m + 1) - m
    # a[y + m + dy', x + ...]: b(y) matches a(y + dy) => flow c0->c1 is -d
    return jnp.stack([-dx, -dy], axis=1).astype(jnp.int32)


def lk_affine(
    c0: jax.Array,            # [H, W] template (coarse grayscale)
    c1: jax.Array,            # [H, W] target, pre-translated
    warp_fn=None,             # (img, u, v) -> img warped by +(u, v)
    n_iters: int = 8,
    huber_delta: float = 3.0,  # x median residual (adaptive)
) -> jax.Array:
    """Direct parametric (Lucas-Kanade) affine alignment: Gauss-Newton on
    image intensities with template gradients and a Huber reweighting.

    Why not fit the affine to a coarse TV-L1 flow field: the TV prior
    FLATTENS divergent fields (a 5% camera zoom is recovered at <10% of its
    magnitude), so an affine fit on that flow under-compensates zoom and
    rotation — the failure mode dense_flow avoids by fitting its homography
    to feature matches instead of regularized flow. LK needs no flow field
    at all: 6 unknowns, a 6x6 solve per iteration, robust reweighting
    against foreground outliers.

    Returns the 2x3 matrix A with u(x, y) = A @ [x, y, 1] (displacement per
    THIS grid's pixel coordinates — rescale with affine_to_native_coords
    before applying at another resolution).
    """
    h, w = c0.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    sxn, syn = 2.0 / w, 2.0 / h
    xn = xs * sxn - 1.0
    yn = ys * syn - 1.0

    gy, gx = jnp.gradient(c0)
    # steepest-descent images for params (p0..p2: u; p3..p5: v)
    sd = jnp.stack([gx * xn, gx * yn, gx, gy * xn, gy * yn, gy])  # [6, H, W]

    if warp_fn is None:
        from videoquery.kernels.warp import bilinear_sample

        def warp_fn(img, u, v):
            return bilinear_sample(img, ys + v, xs + u)

    def body(p, _):
        u = p[0] * xn + p[1] * yn + p[2]
        v = p[3] * xn + p[4] * yn + p[5]
        r = warp_fn(c1, u, v) - c0
        absr = jnp.abs(r)
        # ADAPTIVE robust threshold (approximates the reference's RANSAC
        # inlier selection): background residuals sit near the median, an
        # independently moving foreground sits far above it and must not
        # drag the camera fit toward its own motion
        thresh = huber_delta * jnp.median(absr) + 1e-6
        wgt = jnp.minimum(1.0, thresh / (absr + 1e-8))
        sw = sd * wgt
        hess = jnp.einsum("ihw,jhw->ij", sw, sd,
                          precision=_HIGHEST) + 1e-6 * jnp.eye(6)
        b = jnp.einsum("ihw,hw->i", sw, r, precision=_HIGHEST)
        # residual r = c1(x+u) - c0 ~ r + sd . delta = 0 -> delta = -H^-1 b
        return p - jnp.linalg.solve(hess, b), None

    p, _ = jax.lax.scan(body, jnp.zeros(6), None, length=n_iters)
    # un-normalize (same pattern as estimate_affine): per-pixel coords
    return jnp.asarray([
        [p[0] * sxn, p[1] * syn, p[2] - p[0] - p[1]],
        [p[3] * sxn, p[4] * syn, p[5] - p[3] - p[4]],
    ])


def homography_params(Hn: jax.Array) -> jax.Array:
    """[..., 3, 3] normalized homography (H22 == 1) -> the 8-vector p used
    by lk_homography_batch's parameterization."""
    return jnp.stack([
        Hn[..., 0, 0] - 1.0, Hn[..., 0, 1], Hn[..., 0, 2],
        Hn[..., 1, 0], Hn[..., 1, 1] - 1.0, Hn[..., 1, 2],
        Hn[..., 2, 0], Hn[..., 2, 1],
    ], axis=-1)


def lk_homography_batch(
    c0: jax.Array,            # [N, H, W]
    c1: jax.Array,            # [N, H, W], pre-translated
    warp_fn=None,             # ([N,H,W], u, v) -> warped [N,H,W]
    n_iters: int = 8,
    huber_delta: float = 3.0,
    p0: jax.Array | None = None,  # [N, 8] warm-start params (a neighbor's
                                  # fit); skips the from-zero convergence
) -> jax.Array:
    """Batched direct 8-param homography alignment (lk_affine_batch's two
    extra Gauss-Newton columns — the perspective terms dense_flow's
    SURF+RANSAC homography carries and an affine cannot,
    build_wof_clips.py:70-73).

    Parameterization is projective in NORMALIZED coords xn = 2x/W - 1:
        [xs, ys, s] = Hn @ [xn, yn, 1],  src_n = (xs/s, ys/s)
        Hn = [[1+p0, p1, p2], [p3, 1+p4, p5], [p6, p7, 1]]
    Returns Hn [N, 3, 3] — resolution-independent: apply on ANY grid
    covering the same field of view via homography_displacement (zoom,
    rotation, pan all remain exact sub-cases with p6 = p7 = 0)."""
    n, h, w = c0.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    sxn, syn = 2.0 / w, 2.0 / h
    xn = xs * sxn - 1.0
    yn = ys * syn - 1.0
    gy = jnp.gradient(c0, axis=1)
    gx = jnp.gradient(c0, axis=2)
    # steepest-descent images at p=0 — displacement is in normalized units,
    # pixel-valued residual gradients chain through 1/sxn (resp. 1/syn)
    gxp = gx / sxn
    gyp = gy / syn
    sd = jnp.stack([
        gxp * xn, gxp * yn, gxp,
        gyp * xn, gyp * yn, gyp,
        -(gxp * xn * xn + gyp * xn * yn),   # d/dp6
        -(gxp * xn * yn + gyp * yn * yn),   # d/dp7
    ], axis=1)                               # [N, 8, H, W]

    if warp_fn is None:
        from videoquery.kernels.warp import bilinear_sample

        def warp_fn(img, u, v):
            return jax.vmap(lambda im, uu, vv: bilinear_sample(
                im, ys + vv, xs + uu))(img, u, v)

    def disp(p):
        """(u, v) pixel displacement fields from params [N, 8]."""
        num_x = ((1.0 + p[:, 0, None, None]) * xn + p[:, 1, None, None] * yn
                 + p[:, 2, None, None])
        num_y = (p[:, 3, None, None] * xn + (1.0 + p[:, 4, None, None]) * yn
                 + p[:, 5, None, None])
        den = p[:, 6, None, None] * xn + p[:, 7, None, None] * yn + 1.0
        u = (num_x / den - xn) / sxn
        v = (num_y / den - yn) / syn
        return u, v

    def body(p, _):
        u, v = disp(p)
        r = warp_fn(c1, u, v) - c0
        absr = jnp.abs(r)
        thresh = (huber_delta
                  * jnp.median(absr[:, ::2, ::2], axis=(1, 2), keepdims=True)
                  + 1e-6)
        wgt = jnp.minimum(1.0, thresh / (absr + 1e-8))
        sw = sd * wgt[:, None]
        hess = jnp.einsum("nihw,njhw->nij", sw, sd,
                          precision=_HIGHEST) + 1e-6 * jnp.eye(8)
        b = jnp.einsum("nihw,nhw->ni", sw, r, precision=_HIGHEST)
        delta = jnp.linalg.solve(hess, b[..., None])[..., 0]
        return p - delta, None

    init = jnp.zeros((n, 8)) if p0 is None else p0
    p, _ = jax.lax.scan(body, init, None, length=n_iters)
    row0 = jnp.stack([1.0 + p[:, 0], p[:, 1], p[:, 2]], axis=1)
    row1 = jnp.stack([p[:, 3], 1.0 + p[:, 4], p[:, 5]], axis=1)
    row2 = jnp.stack([p[:, 6], p[:, 7], jnp.ones_like(p[:, 0])], axis=1)
    return jnp.stack([row0, row1, row2], axis=1)       # [N, 3, 3]


def homography_translate(Hn: jax.Array, tx, ty, w: int, h: int) -> jax.Array:
    """Compose a PIXEL translation (applied after the homography) into Hn:
    total displacement = disp(Hn) + (tx, ty). In normalized units a
    constant shift adds t_n * denominator to the numerator rows."""
    txn = tx * (2.0 / w)
    tyn = ty * (2.0 / h)
    Hn = Hn.at[..., 0, :].add(txn[..., None] * Hn[..., 2, :])
    return Hn.at[..., 1, :].add(tyn[..., None] * Hn[..., 2, :])


def homography_displacement(Hn: jax.Array, h: int, w: int):
    """Pixel displacement fields (u [.., H, W], v) of normalized-coords
    homographies Hn [..., 3, 3] evaluated on an (h, w) grid covering the
    same [-1, 1]^2 field of view (resolution/anisotropy independent)."""
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    sxn, syn = 2.0 / w, 2.0 / h
    xn = xs * sxn - 1.0
    yn = ys * syn - 1.0
    lead = Hn.shape[:-2]
    H = Hn.reshape(lead + (3, 3, 1, 1))
    num_x = H[..., 0, 0, :, :] * xn + H[..., 0, 1, :, :] * yn + H[..., 0, 2, :, :]
    num_y = H[..., 1, 0, :, :] * xn + H[..., 1, 1, :, :] * yn + H[..., 1, 2, :, :]
    den = H[..., 2, 0, :, :] * xn + H[..., 2, 1, :, :] * yn + H[..., 2, 2, :, :]
    u = (num_x / den - xn) / sxn
    v = (num_y / den - yn) / syn
    return u, v


def lk_affine_batch(
    c0: jax.Array,            # [N, H, W]
    c1: jax.Array,            # [N, H, W], pre-translated
    warp_fn=None,             # ([N,H,W], u, v) -> warped [N,H,W]
    n_iters: int = 8,
    huber_delta: float = 3.0,  # x median residual (adaptive)
) -> jax.Array:
    """Batched lk_affine: returns [N, 2, 3] per-pixel-coords affines.
    warp_fn (batched) defaults to the exact bilinear gather."""
    n, h, w = c0.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    sxn, syn = 2.0 / w, 2.0 / h
    xn = xs * sxn - 1.0
    yn = ys * syn - 1.0
    gy = jnp.gradient(c0, axis=1)
    gx = jnp.gradient(c0, axis=2)
    sd = jnp.stack([gx * xn, gx * yn, gx, gy * xn, gy * yn, gy], axis=1)

    if warp_fn is None:
        from videoquery.kernels.warp import bilinear_sample

        def warp_fn(img, u, v):
            return jax.vmap(lambda im, uu, vv: bilinear_sample(
                im, ys + vv, xs + uu))(img, u, v)

    def body(p, _):
        u = p[:, 0, None, None] * xn + p[:, 1, None, None] * yn + p[:, 2, None, None]
        v = p[:, 3, None, None] * xn + p[:, 4, None, None] * yn + p[:, 5, None, None]
        r = warp_fn(c1, u, v) - c0
        absr = jnp.abs(r)
        # median on a 2x2-strided subsample: statistically identical scale
        # estimate at 1/4 the sort cost (the sort is the LK loop's single
        # most expensive op at production batch sizes)
        thresh = (huber_delta
                  * jnp.median(absr[:, ::2, ::2], axis=(1, 2), keepdims=True)
                  + 1e-6)
        wgt = jnp.minimum(1.0, thresh / (absr + 1e-8))
        sw = sd * wgt[:, None]
        hess = jnp.einsum("nihw,njhw->nij", sw, sd,
                          precision=_HIGHEST) + 1e-6 * jnp.eye(6)
        b = jnp.einsum("nihw,nhw->ni", sw, r, precision=_HIGHEST)
        delta = jnp.linalg.solve(hess, b[..., None])[..., 0]
        return p - delta, None

    p, _ = jax.lax.scan(body, jnp.zeros((n, 6)), None, length=n_iters)
    return jnp.stack([
        jnp.stack([p[:, 0] * sxn, p[:, 1] * syn,
                   p[:, 2] - p[:, 0] - p[:, 1]], axis=1),
        jnp.stack([p[:, 3] * sxn, p[:, 4] * syn,
                   p[:, 5] - p[:, 3] - p[:, 4]], axis=1),
    ], axis=1)
