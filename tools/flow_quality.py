"""Flow quality gate: does a flow schedule change flow accuracy or retrieval?

Generates a synthetic corpus of clips with distinct motion signatures
(different object velocities + camera pans over textured backgrounds) whose
ground-truth motion is known, then for each flow configuration reports
  - endpoint error (EPE) of the camera-compensated flow against the truth
    (mean, p90, object box, background), and
  - retrieval: the fraction of clips whose nearest flow-embedding neighbor
    is their motion partner.
The default run compares the shipped schedule (pipeline/extract.py's
PRODUCTION_TVL1 + ExtractionConfig's warm start, "init" warm camera and
bf16 gray fold) with the cold full solve of every pair.

Run: python tools/flow_quality.py --seeds 0 1 2 --scale 2
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


MOTION_CLASSES = [  # (object velocity, camera pan) — strongly distinct
    ((4.0, 0.0), (0.0, 0.0)),    # fast right
    ((-4.0, 0.0), (0.0, 0.0)),   # fast left
    ((0.0, 3.0), (0.0, 0.0)),    # down
    ((0.0, -3.0), (0.0, 0.0)),   # up
    ((0.0, 0.0), (0.0, 0.0)),    # static
    ((2.5, 2.5), (1.5, 0.0)),    # diagonal + pan (tests compensation)
    ((12.0, 0.0), (0.0, 0.0)),   # very fast right: >10 px/frame foreground,
                                 # near the reference's ±20 px quantization
                                 # bound (build_wof_clips.py:70-73)
    ((-7.0, 5.0), (2.0, 0.0)),   # fast diagonal + pan. NOTE: the object
                                 # motion must be UNIQUE per class — with
                                 # accurate camera compensation the pan is
                                 # (correctly) erased, so a pan class whose
                                 # object motion matches another class's
                                 # direction collapses onto it and the
                                 # metric punishes good compensation
    ((3.0, -3.0), "zoom"),       # camera zoom-in + diagonal object: tests
                                 # the parametric (LK) compensation — the
                                 # TV-flow-affine-fit estimator left zooms
                                 # uncompensated
    ((-2.5, -2.5), "jitter"),    # handheld-style pan with per-frame random
                                 # jitter: camera motion is NOT smooth
                                 # between neighbor pairs, so any scheme
                                 # that reuses a neighbor's camera estimate
                                 # (warm-start shortcuts) is punished here
    ((5.0, 1.5), "perspx"),      # camera PERSPECTIVE change about the
                                 # vertical axis (dash-cam/drone motion):
                                 # inexpressible by the affine model —
                                 # gates TVL1Params.camera_model
    ((-1.5, -5.0), "perspy"),    # perspective about the horizontal axis
]
ZOOM_PER_FRAME = 0.004           # 0.4%/frame zoom-in
JITTER_PAN = (1.5, 0.0)          # mean pan of the jitter class
JITTER_STD = 1.25                # px/frame camera jitter (per axis)

# CORPUS v4 (round 5): time-varying object motion + mid-clip content
# change. The v3 classes all have CONSTANT per-clip motion, so any evenly
# spaced tick subset sees the same signal (the tick-budget curve was flat
# by construction) and a warm-started neighbor pair's flow is always a
# good initializer (warm staleness was never stressed). These classes make
# both axes measurable:
#   - accel:   velocity grows linearly 0 -> ~2x the fast classes
#   - reverse: direction flips at mid-clip (worst case for warm chains)
#   - burst:   motion confined to a ~20% window of the clip (tick budgets
#              under-sample the event; mean-pooled embeddings get a
#              high-variance estimate of the motion share)
#   - cut:     the scene content is REPLACED mid-clip (texture and object;
#              the cut pair has no correspondence, so warm starts across
#              it inject garbage)
# Spec: {"kind", ...} per-frame velocity program + pan ("cut" = static
# camera with the content switch).
V4_CLASSES = [
    ({"kind": "accel", "a": (0.30, 0.0)}, (0.0, 0.0)),
    ({"kind": "accel", "a": (0.0, -0.22)}, (0.0, 0.0)),
    ({"kind": "reverse", "v": (5.0, 0.0)}, (0.0, 0.0)),
    ({"kind": "reverse", "v": (0.0, 4.0)}, (1.5, 0.0)),
    ({"kind": "burst", "v": (8.0, 0.0), "t0": 0.35, "t1": 0.55}, (0.0, 0.0)),
    ({"kind": "burst", "v": (0.0, 8.0), "t0": 0.65, "t1": 0.85}, (0.0, 0.0)),
    ({"kind": "const", "v": (3.0, 1.0)}, "cut"),
    ({"kind": "const", "v": (-3.0, -1.0)}, "cut"),
]


def _v4_vels(spec, frames: int) -> "np.ndarray":
    """Per-pair object velocity program [frames, 2] (px/frame, pre-scale)."""
    t = np.arange(frames, dtype=np.float64)[:, None]
    kind = spec["kind"]
    if kind == "accel":
        return t * np.asarray(spec["a"])[None]
    if kind == "reverse":
        v = np.asarray(spec["v"], np.float64)
        return np.where(t < frames // 2, v[None], -v[None])
    if kind == "burst":
        v = np.asarray(spec["v"], np.float64)
        on = (t >= spec["t0"] * frames) & (t < spec["t1"] * frames)
        return np.where(on, v[None], 0.0)
    if kind == "const":
        return np.broadcast_to(np.asarray(spec["v"], np.float64),
                               (frames, 2)).copy()
    raise ValueError(kind)
PERSP_RATE = 0.008               # perspective accumulation per frame (the
                                 # h31/h32 term in normalized [-1,1] coords:
                                 # ~0.7 px/frame of camera motion at the
                                 # frame edge at w=176, quadratic profile)


def _persp_mats(pan: str, t: float, h: int, w: int) -> "np.ndarray":
    """Output-window px -> base px homography for the persp classes at
    frame t (base is the 2h x 2w texture; window starts centered)."""
    kx = PERSP_RATE if pan == "perspx" else 0.0
    ky = PERSP_RATE if pan == "perspy" else 0.0
    N = np.array([[2.0 / w, 0, -1], [0, 2.0 / h, -1], [0, 0, 1]])
    C = np.array([[1, 0, 0], [0, 1, 0], [kx * t, ky * t, 1.0]])
    T = np.array([[1, 0, w / 2.0], [0, 1, h / 2.0], [0, 0, 1]])
    return T @ np.linalg.inv(N) @ C @ N


def make_corpus(frames=30, h=128, w=176, seed=0, scale=1, with_truth=False,
                version=4):
    """Two clips per motion class (different textures/objects, same motion):
    the retrieval metric is whether each clip's nearest flow-neighbor is its
    motion partner. scale multiplies resolution, object size AND velocities
    (proportional motion at production-like frame sizes).

    version=4 (default) appends the time-varying V4_CLASSES (accelerating /
    reversing / burst motion, mid-clip content cuts) to the 12 constant-
    motion v3 classes; version=3 reproduces the round-4 corpus exactly
    (the v3 gate numbers stay comparable).

    with_truth=True additionally returns per-clip ground-truth metadata
    (object box track + camera model) — the scenes are generated from KNOWN
    motion fields, so endpoint error against them is free (VERDICT r2 #3)."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w, osz = h * scale, w * scale, 28 * scale
    classes = list(MOTION_CLASSES)
    if version >= 4:
        classes += V4_CLASSES
    clips, labels, truths = [], [], []
    for ci, (obj_v, pan) in enumerate(classes):
        for rep in range(2):
            # CORPUS v3 (round 4): coherent multi-scale textures at full
            # contrast. The original corpus Gaussian-blurred iid noise
            # (std collapsed to ~5/255 at scale 2 — BELOW TV-L1's
            # soft-threshold floor lambda*theta=0.045) and pasted an
            # UNBLURRED-noise object (near-zero spatial correlation, so
            # its motion is barely matchable at any speed). Measured
            # consequence: the solver returned near-zero flow on the
            # scale-2 corpus — a pure 3 px roll of a corpus frame solved
            # to 0.46 px — so object EPE degenerated to the truth
            # magnitude for EVERY config ("pinned ~10.4" was corpus
            # texture, not the window clamp) and only background/relative
            # comparisons carried signal. v3 textures have ~8-16 px
            # features at real-video contrast, making absolute EPE
            # meaningful; all gates were re-run on v3.
            def _texture(hh, ww, coarse=16, fine=4):
                layers = []
                for cell, wgt in ((coarse, 1.0), (fine, 0.5)):
                    n_ = rng.random((hh // cell + 2, ww // cell + 2, 3))
                    layers.append(wgt * cv2.resize(
                        n_, (ww, hh), interpolation=cv2.INTER_CUBIC))
                t = sum(layers)
                t -= t.min()
                return (t / max(t.max(), 1e-9) * 255).astype(np.uint8)

            base = _texture(h * 2, w * 2, coarse=16 * scale,
                            fine=4 * scale)
            obj = _texture(osz, osz, coarse=8 * scale, fine=3 * scale)
            obj_xy = np.array([w * 0.25, h * 0.25]) + rng.uniform(0, 15 * scale, 2)
            fr, track, origins = [], [], []
            jitter = (rng.normal(0, JITTER_STD * scale, (frames, 2))
                      if pan == "jitter" else None)
            persp_mats = []
            if isinstance(obj_v, dict):  # v4 time-varying program
                vels = _v4_vels(obj_v, frames)
                # cum[t] = position offset at frame t; disp t->t+1 = vels[t]
                cum = np.vstack([np.zeros((1, 2)),
                                 np.cumsum(vels, axis=0)])[:frames]
                peak = np.max(np.abs(vels), axis=0)
                peak_v = (float(peak[0]), float(peak[1]))
            else:
                vels, cum, peak_v = None, None, obj_v
            cut_t, base2, obj2 = None, None, None
            if pan == "cut":
                cut_t = frames // 2
                base2 = _texture(h * 2, w * 2, coarse=16 * scale,
                                 fine=4 * scale)
                obj2 = _texture(osz, osz, coarse=8 * scale, fine=3 * scale)
            for t in range(frames):
                if pan in ("perspx", "perspy"):
                    M = _persp_mats(pan, t, h, w)
                    persp_mats.append(M)
                    f = cv2.warpPerspective(
                        base, M.astype(np.float64), (w, h),
                        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
                    origins.append(None)
                elif pan == "zoom":
                    # camera zoom-in about the window center
                    s = 1.0 + ZOOM_PER_FRAME * t
                    ch, cw = int(round(h / s)), int(round(w / s))
                    y0 = (h * 2 - ch) // 2
                    x0 = (w * 2 - cw) // 2
                    f = cv2.resize(base[y0:y0 + ch, x0:x0 + cw], (w, h))
                    origins.append(None)
                elif pan == "cut":
                    # static camera; the whole scene content is replaced at
                    # mid-clip (base2/obj2) — the cut pair has no pixel
                    # correspondence
                    b = base if t < cut_t else base2
                    f = b[:h, :w].copy()
                    origins.append((0, 0))
                else:
                    px_, py_ = (JITTER_PAN if pan == "jitter" else pan)
                    ox = int(t * px_ * scale
                             + (jitter[t, 0] if jitter is not None else 0)) % w
                    oy = int(t * py_ * scale
                             + (jitter[t, 1] if jitter is not None else 0)) % h
                    f = base[oy:oy + h, ox:ox + w].copy()
                    origins.append((ox, oy))
                if cum is not None:  # v4 time-varying program
                    px = int(obj_xy[0] + cum[t, 0] * scale) % (w - osz)
                    py = int(obj_xy[1] + cum[t, 1] * scale) % (h - osz)
                else:
                    px = int(obj_xy[0] + t * obj_v[0] * scale) % (w - osz)
                    py = int(obj_xy[1] + t * obj_v[1] * scale) % (h - osz)
                cur_obj = (obj2 if (cut_t is not None and t >= cut_t
                                    and obj2 is not None) else obj)
                f[py:py + osz, px:px + osz] = cur_obj
                fr.append(f)
                track.append((px, py))
            clips.append(np.stack(fr))
            labels.append(ci)
            truths.append({"obj_v": peak_v, "pan": pan, "osz": osz,
                           "track": track, "origins": origins,
                           "scale": scale, "persp_mats": persp_mats,
                           "vels": vels, "cut_t": cut_t})
    clips = np.stack(clips)
    labels = np.asarray(labels)
    if with_truth:
        return clips, labels, truths
    return clips, labels  # [C, F, H, W, 3], [C]


def truth_residual_flow(meta, t, h, w):
    """Ground-truth CAMERA-COMPENSATED (residual) flow for pair t -> t+1,
    or None when the pair is untestable (object or pan modulo-wrap).

    Returns (field f32[h, w, 2], valid_mask bool[h, w]). Background residual
    is 0 by construction (ideal compensation erases the pan/zoom); the
    object box at frame t carries its true displacement minus the camera
    field there (what TV-L1 on the ideally-warped pair measures). The
    object's frame-t+1 footprint is masked out (occlusion/disocclusion has
    no single ground truth)."""
    (px0, py0), (px1, py1) = meta["track"][t], meta["track"][t + 1]
    osz = meta["osz"]
    scale = meta["scale"]
    obj_v, pan = meta["obj_v"], meta["pan"]
    vels = meta.get("vels")
    cut_t = meta.get("cut_t")
    if cut_t is not None and t + 1 == cut_t:
        return None  # the cut pair has no pixel correspondence
    if vels is not None:
        # v4 time-varying program: the pair's displacement is vels[t]
        # (+2.5: int-rounding of both endpoint positions)
        if (abs(px1 - px0) > abs(vels[t, 0]) * scale + 2.5
                or abs(py1 - py0) > abs(vels[t, 1]) * scale + 2.5):
            return None  # object modulo-wrap
    elif (abs(px1 - px0) > abs(obj_v[0]) * scale + 1.5
            or abs(py1 - py0) > abs(obj_v[1]) * scale + 1.5):
        return None  # object modulo-wrap
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    if pan in ("perspx", "perspy"):
        # content at output x in frame t sits at base point M_t x; in frame
        # t+1 it appears at M_{t+1}^-1 M_t x — the exact camera field
        M0, M1 = meta["persp_mats"][t], meta["persp_mats"][t + 1]
        P = np.linalg.inv(M1) @ M0
        denom = P[2, 0] * xs + P[2, 1] * ys + P[2, 2]
        cam_x = (P[0, 0] * xs + P[0, 1] * ys + P[0, 2]) / denom - xs
        cam_y = (P[1, 0] * xs + P[1, 1] * ys + P[1, 2]) / denom - ys
    elif pan == "zoom":
        s0 = 1.0 + ZOOM_PER_FRAME * t
        s1 = 1.0 + ZOOM_PER_FRAME * (t + 1)
        r = s1 / s0 - 1.0
        cam_x = (xs - (w - 1) / 2.0) * r
        cam_y = (ys - (h - 1) / 2.0) * r
    elif pan == "cut":
        cam_x = np.zeros((h, w), np.float32)  # static camera
        cam_y = np.zeros((h, w), np.float32)
    else:
        (ox0, oy0), (ox1, oy1) = meta["origins"][t], meta["origins"][t + 1]
        dox, doy = ox1 - ox0, oy1 - oy0
        if pan == "jitter":
            lim_x = (abs(JITTER_PAN[0]) + 5 * JITTER_STD) * scale + 1.5
            lim_y = (abs(JITTER_PAN[1]) + 5 * JITTER_STD) * scale + 1.5
        else:
            lim_x = abs(pan[0]) * scale + 1.5
            lim_y = abs(pan[1]) * scale + 1.5
        if abs(dox) > lim_x or abs(doy) > lim_y:
            return None  # pan wrapped
        cam_x = np.full((h, w), -float(dox), np.float32)
        cam_y = np.full((h, w), -float(doy), np.float32)
    field = np.zeros((h, w, 2), np.float32)
    in_box0 = np.zeros((h, w), bool)
    in_box0[py0:py0 + osz, px0:px0 + osz] = True
    field[..., 0] = np.where(in_box0, (px1 - px0) - cam_x, 0.0)
    field[..., 1] = np.where(in_box0, (py1 - py0) - cam_y, 0.0)
    valid = np.ones((h, w), bool)
    # frame-t+1 object footprint: disoccluded background, no ground truth
    valid[py1:py1 + osz, px1:px1 + osz] = False
    valid[py0:py0 + osz, px0:px0 + osz] = True  # box0 keeps its truth
    return field, valid


def _flow_setup(clips, flow_res_div, gray_matmul, host_gray):
    """Production flow geometry for a clip batch: (gray f32 [C, F, fh, fw]
    on device, value scale), from the device gray path (extract.py's
    _flow_gray_grid, bf16 matmul fold when gray_matmul) or the host-gray
    upload path (host_gray = cv2 interp name)."""
    import jax
    import jax.numpy as jnp

    from videoquery.pipeline.extract import _flow_gray_grid, flow_grid_shape

    c, f, h, w = clips.shape[:4]
    if host_gray:
        from videoquery.pipeline import decode

        fh, fw = flow_grid_shape(h, w, flow_res_div)
        gh = decode.gray_flow_grid(
            clips.reshape((c * f,) + clips.shape[2:]), fh, fw,
            interp=host_gray)
        g = jnp.asarray(gh.reshape(c, f, fh, fw).astype(np.float32) / 255.0)
        return g, (w / fw, h / fh)
    return jax.jit(_flow_gray_grid, static_argnames=(
        "flow_res_div", "matmul"))(jnp.asarray(clips),
                                   flow_res_div=flow_res_div,
                                   matmul=gray_matmul)


def _warm_plan(pair_idx, warm_group):
    import jax.numpy as jnp

    from videoquery.pipeline.sampling import flow_warm_plan

    if warm_group <= 1:
        return None
    kp, wp, ws = flow_warm_plan(pair_idx, warm_group)
    return (jnp.asarray(kp), jnp.asarray(wp), jnp.asarray(ws)) \
        if wp.size else None


def epe_for_config(clips, truths, tvl1, flow_res_div, margin=12,
                   warm_group=0, warm_camera="own", gray_matmul=False,
                   host_gray="", only_pans=None):
    """Mean/percentile endpoint error of a flow config against the corpus's
    known residual-motion fields, reproducing the production flow geometry
    (grayscale, reduced grid, value rescale — extract.py's _extract_step).
    Also splits EPE into object-box vs background (the background number
    isolates camera-compensation quality). Every pair of every clip is
    scored; warm_group > 1 evaluates the temporal warm-start path."""
    import jax
    import jax.numpy as jnp

    from videoquery.pipeline.extract import _pair_flow_uv

    c, f, h, w = clips.shape[:4]
    g, vscale = _flow_setup(clips, flow_res_div, gray_matmul, host_gray)
    fh, fw = g.shape[2:4]
    pair_idx = np.arange(f - 1, dtype=np.int32)
    u, v = jax.jit(_pair_flow_uv,
                   static_argnames=("warped", "tvl1", "warm_camera"))(
        g, jnp.asarray(pair_idx), True, tvl1, _warm_plan(pair_idx, warm_group),
        warm_camera=warm_camera)
    u = u.reshape(c * (f - 1), fh, fw)
    v = v.reshape(c * (f - 1), fh, fw)

    # ground truth + masks assembled host-side, error reduced ON DEVICE
    gts, valids, boxes, keep = [], [], [], []
    for ci in range(c):
        for t in range(f - 1):
            # only_pans restricts the error accounting to specific camera
            # classes (the camera-model gate)
            include = only_pans is None or truths[ci]["pan"] in only_pans
            gt = (truth_residual_flow(truths[ci], t, h, w)
                  if include else None)
            if gt is None:
                gts.append(np.zeros((h, w, 2), np.float32))
                valids.append(np.zeros((h, w), bool))
                boxes.append(np.zeros((h, w), bool))
                keep.append(False)
                continue
            field, valid = gt
            m = valid.copy()
            m[:margin] = m[-margin:] = False
            m[:, :margin] = m[:, -margin:] = False
            gts.append(field)
            valids.append(m)
            boxes.append(np.abs(field).sum(-1) > 0)
            keep.append(m.any())
    # pass the truth tensors as ARGUMENTS: closed-over arrays would be
    # baked into the program as constants (90+ MB of literals)
    gt_j = jnp.asarray(np.stack(gts))
    valid_j = jnp.asarray(np.stack(valids)) & jnp.asarray(keep)[:, None, None]
    box_j = jnp.asarray(np.stack(boxes))

    @jax.jit
    def stats(u_, v_, gt, valid, box):
        uu = jax.image.resize(u_ * vscale[0], (c * (f - 1), h, w), "linear")
        vv = jax.image.resize(v_ * vscale[1], (c * (f - 1), h, w), "linear")
        err = jnp.sqrt((uu - gt[..., 0]) ** 2 + (vv - gt[..., 1]) ** 2)
        nan = jnp.float32(jnp.nan)
        masked = jnp.where(valid, err, nan)
        obj = jnp.where(valid & box, err, nan)
        bg = jnp.where(valid & ~box, err, nan)
        return (jnp.nanmean(masked), jnp.nanpercentile(masked, 90),
                jnp.nanmean(obj), jnp.nanmean(bg))

    mean, p90, obj, bg = (float(x)
                          for x in stats(u, v, gt_j, valid_j, box_j))
    return {"epe_mean": mean, "epe_p90": p90, "epe_obj": obj, "epe_bg": bg}


def extract(clips, tvl1, flow_res_div, tsn, warm_group=0,
            warm_camera="own", gray_matmul=False, host_gray=""):
    """Flow and rgb embeddings [K, C, D] of the corpus through the fused
    production step (_extract_step) with a 9-tick plan."""
    import jax.numpy as jnp

    from videoquery.pipeline.extract import _extract_step, flow_grid_shape
    from videoquery.pipeline.sampling import flow_pair_plan, frame_ticks

    c, f = clips.shape[:2]
    ticks_np = frame_ticks(f, 9, 1) - 1
    ticks = jnp.asarray(ticks_np, jnp.int32)
    kw = {}
    frames_in = clips
    if host_gray:
        from videoquery.pipeline import decode

        h, w = clips.shape[2:4]
        fh, fw = flow_grid_shape(h, w, flow_res_div)
        gh = decode.gray_flow_grid(
            clips.reshape((c * f,) + clips.shape[2:]), fh, fw,
            interp=host_gray)
        kw["gray_u8"] = jnp.asarray(gh.reshape(c, f, fh, fw))
        frames_in = np.ascontiguousarray(clips[:, ticks_np])
    pair_idx, stack_pos = flow_pair_plan(f, 9, 5)
    warm = _warm_plan(pair_idx, warm_group)
    if warm is not None:
        kw["flow_warm_plan"] = warm
    rgb, flow = _extract_step(
        tsn.rgb.stacked_params, tsn.flow.stacked_params,
        jnp.asarray(frames_in), ticks, jnp.asarray(stack_pos, jnp.int32),
        20.0, True, tvl1, (340, 256), 224, "float32",
        jnp.asarray(pair_idx, jnp.int32), flow_res_div,
        flow_warm_camera=warm_camera, flow_gray_matmul=gray_matmul, **kw,
    )
    return np.asarray(rgb, np.float64), np.asarray(flow, np.float64)


def cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1) + 1e-12)


def ranking(emb):  # [K, C, D] -> per-clip neighbor order by mean-split cosine
    e = emb.mean(axis=0)
    sims = cosine(e[:, None], e[None, :])
    return np.argsort(-sims, axis=1)


def partner_accuracy(emb, labels):
    """Fraction of clips whose nearest flow-neighbor shares their motion
    class (each class has exactly one partner)."""
    e = emb.mean(axis=0)
    sims = cosine(e[:, None], e[None, :])
    np.fill_diagonal(sims, -np.inf)
    nn = sims.argmax(axis=1)
    return float((labels[nn] == labels).mean())


def main():
    import argparse
    import dataclasses

    import jax

    from videoquery.core.jaxsetup import setup_jax

    setup_jax()  # persistent compile cache across gate invocations

    from videoquery.core.config import ExtractionConfig
    from videoquery.kernels.tvl1 import TVL1Params
    from videoquery.nn.tsn import TwoStreamTSN
    from videoquery.pipeline.extract import PRODUCTION_TVL1

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="corpus seeds; metrics average across them")
    ap.add_argument("--corpus", type=int, default=4, choices=[3, 4],
                    help="corpus version: 4 (default) adds time-varying "
                         "motion + content cuts; 3 = the constant-motion "
                         "corpus (its gate numbers stay comparable)")
    ap.add_argument("--scale", type=int, default=1,
                    help="corpus resolution/motion multiplier (2 =~ the "
                         "production 256x340 decode geometry)")
    ap.add_argument("--no_epe", action="store_true",
                    help="skip the ground-truth endpoint-error metric "
                         "(retrieval accuracy only)")
    ap.add_argument("--sweep", action="store_true",
                    help="add reduced-iteration schedule candidates")
    ap.add_argument("--res_sweep", action="store_true",
                    help="sweep flow_res_div and the camera grid at the "
                         "production schedule")
    ap.add_argument("--warm_iters", action="store_true",
                    help="sweep the warm-pair refinement iteration count "
                         "(TVL1Params.warm_iters)")
    ap.add_argument("--camera", action="store_true",
                    help="gate TVL1Params.camera_model (homography vs "
                         "affine); also reports persp-class-only EPE")
    ap.add_argument("--host_gray", action="store_true",
                    help="gate the compact-upload host gray source "
                         "(cv2 uint8, ExtractionConfig.host_gray) against "
                         "the on-device gray")
    args = ap.parse_args()

    ship = ExtractionConfig()
    # a config: (tvl1, flow_res_div, warm_group, warm_camera, gray_matmul,
    # host_gray interp)
    shipped = (PRODUCTION_TVL1, ship.flow_res_div, ship.flow_warm_group,
               ship.flow_warm_camera, ship.flow_gray_matmul, "")
    configs = {
        # imported from the Extractor defaults so this row always measures
        # the schedule that actually ships
        "shipped (warm g3, init camera)": shipped,
        "cold full solve": (PRODUCTION_TVL1, ship.flow_res_div, 0, "own",
                            ship.flow_gray_matmul, ""),
    }

    def variant(tvl1=PRODUCTION_TVL1, **kw):
        cfg = dict(zip(("tvl1", "div", "group", "camera", "graymm", "hg"),
                       shipped), tvl1=tvl1)
        cfg.update(kw)
        return tuple(cfg.values())

    P = PRODUCTION_TVL1
    if args.res_sweep:
        configs.update({
            "coarse 64x96": variant(dataclasses.replace(P, coarse_hw=(64, 96))),
            "coarse 32x48": variant(dataclasses.replace(P, coarse_hw=(32, 48))),
            "div3": variant(div=3),
            "div4": variant(div=4),
        })
    if args.warm_iters:
        configs.update({
            "warm_iters=fine (10)": variant(
                dataclasses.replace(P, warm_iters=None)),
            "warm_iters=16": variant(dataclasses.replace(P, warm_iters=16)),
            "warm_iters=16 warps2": variant(
                dataclasses.replace(P, warm_iters=16, warm_warps=2)),
            "warm camera own": variant(camera="own"),
            "warm camera key": variant(camera="key"),
        })
    if args.camera:
        configs["affine camera"] = variant(
            dataclasses.replace(P, camera_model="affine"))
    if args.host_gray:
        configs.update({
            "host gray cv2 area2": variant(hg="area2"),
            "host gray cv2 area": variant(hg="area"),
            "device gray exact f32": variant(graymm=False),
        })
    if args.sweep:
        configs.update({
            "s5 w5 i30 (OpenCV defaults)": variant(TVL1Params(
                fine_warps=2, camera_model="homography")),
            "s4 w2 i12 fi8": variant(TVL1Params(
                n_scales=4, n_warps=2, fine_warps=2, n_iters=12,
                fine_iters=8, warm_iters=6, camera_model="homography")),
            "s3 w2 i10 fi6": variant(TVL1Params(
                n_scales=3, n_warps=2, fine_warps=2, n_iters=10,
                fine_iters=6, warm_iters=6, camera_model="homography")),
        })

    tsn = TwoStreamTSN.random(jax.random.PRNGKey(0), splits=(1,))
    accs = {name: [] for name in configs}
    epes = {name: [] for name in configs}
    for seed in args.seeds:
        clips, labels, truths = make_corpus(seed=seed, scale=args.scale,
                                            with_truth=True,
                                            version=args.corpus)
        for name, (tvl1, div, wg, wc, gm, hg) in configs.items():
            t0 = time.time()
            _rgb, flow = extract(clips, tvl1, div, tsn, warm_group=wg,
                                 warm_camera=wc, gray_matmul=gm,
                                 host_gray=hg)
            acc = partner_accuracy(flow, labels)
            accs[name].append(acc)
            line = (f"[{time.time()-t0:6.1f}s] seed {seed} {name:32s} "
                    f"retrieval: {acc:.3f}")
            if not args.no_epe:
                e = epe_for_config(clips, truths, tvl1, div, warm_group=wg,
                                   warm_camera=wc, gray_matmul=gm,
                                   host_gray=hg)
                epes[name].append(e)
                line += (f"  EPE mean {e['epe_mean']:.4f} p90 "
                         f"{e['epe_p90']:.4f} obj {e['epe_obj']:.4f} "
                         f"bg {e['epe_bg']:.4f}")
                if args.camera:
                    ep = epe_for_config(clips, truths, tvl1, div,
                                        warm_group=wg, warm_camera=wc,
                                        gray_matmul=gm, host_gray=hg,
                                        only_pans=("perspx", "perspy"))
                    line += (f"  persp-only mean {ep['epe_mean']:.4f} "
                             f"bg {ep['epe_bg']:.4f}")
            print(line, flush=True)
    print("-- mean over seeds", args.seeds, "scale", args.scale)
    for name, a in accs.items():
        line = f"{name:34s} retrieval {np.mean(a):.4f}  (per-seed {a})"
        if epes[name]:
            line += ("  EPE {:.4f} obj {:.4f} bg {:.4f}".format(
                np.mean([e["epe_mean"] for e in epes[name]]),
                np.mean([e["epe_obj"] for e in epes[name]]),
                np.mean([e["epe_bg"] for e in epes[name]])))
        print(line, flush=True)


if __name__ == "__main__":
    main()
