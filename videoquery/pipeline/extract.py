"""Fused two-stream feature extraction: video -> per-clip 1024-d signatures.

This is the GPU replacement for the reference's two-stage pipeline
(build_wof_clips.py JPEG dump + dense_flow shellouts, then calcSig_wOF.py
Caffe forwards over multiprocessing pools; SURVEY.md §3.2-3.3). Here a video
becomes device arrays once; warped TV-L1 flow, tick sampling, preprocessing
and the 6-member TSN ensemble run as XLA programs; output is either
FeatureRecords for the index or reference-format CSVs.

Pipeline per clip batch (static shapes; one compile per batch geometry):
  frames u8 [B, F, H, W, 3] ──► gray [B, F, H, W] ─► warped TV-L1 ─► quantize
        │                                                   │
        └─► rgb ticks [B, T, h, w, 3] ─► preprocess ─► rgb net (K splits)
                                    flow stacks [B, T, h, w, 10] ─► flow net
  ─► {stream: [K, B, 1024]} per-clip signatures (ticks averaged)
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import time
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from videoquery.core.config import ExtractionConfig, FLOW, RGB
from videoquery.index.csvio import write_features_csv
from videoquery.index.store import FeatureRecord
from videoquery.kernels.tvl1 import (TVL1Params, tvl1_flow, tvl1_flow_warm,
                                     tvl1_warped_flow, tvl1_warped_flow_cam,
                                     tvl1_warped_flow_warm)
from videoquery.nn.tsn import TwoStreamTSN
from videoquery.pipeline import decode
from videoquery.pipeline.preprocess import (
    preprocess_flow,
    preprocess_rgb,
    quantize_flow,
)
from videoquery.pipeline.sampling import (flow_pair_plan,
                                          flow_warm_plan,
                                          frame_ticks)

# jax-free host-side payload machinery (worker processes import THAT module
# directly to avoid the jax import; re-exported here for the device side)
from videoquery.pipeline.payload import (BatchPayload, build_payload,  # noqa: F401
                                         flow_grid_shape, plan_groups,
                                         stream_payloads)

log = logging.getLogger(__name__)

# Production flow schedule: 4 pyramid levels, 3 warps (2 at the finest
# two levels), 20 iterations (10 fine; 6 for a warm pair's refinement
# warp); camera model = HOMOGRAPHY (dense_flow's model class — the persp
# corpus classes need it). With ExtractionConfig's warm group 3 and the
# "init" warm camera this is the schedule tools/flow_quality.py gates (EPE
# and retrieval against the cold full solve, 3 seeds, scale 2); the gate
# imports this constant so it always measures what ships.
PRODUCTION_TVL1 = TVL1Params(n_scales=4, n_warps=3, fine_warps=2,
                             n_iters=20, fine_iters=10, warm_iters=6,
                             camera_model="homography")


def warm_tvl1_params(tvl1: TVL1Params) -> TVL1Params:
    """Refinement schedule for warm-started pairs: one warp pass at the
    fine-iteration count — the init flow already carries the converged
    large-scale motion of a neighbor pair, only the residual needs solving
    (tools/flow_quality.py measures EPE + retrieval against the cold
    path)."""
    # fine_iters=None: iters_at_level() would otherwise clamp the warm
    # budget to the inherited fine_iters, silently capping warm_iters
    # sweep values above it.
    return dataclasses.replace(
        tvl1, n_warps=tvl1.warm_warps, fine_warps=tvl1.warm_warps,
        fine_iters=None,
        n_iters=tvl1.warm_iters or tvl1.fine_iters or tvl1.n_iters)


def _pair_flow_uv(gray: jax.Array, pair_idx: jax.Array, warped: bool,
                  tvl1: TVL1Params, warm_plan=None,
                  warm_camera: str = "own"
                  ) -> tuple[jax.Array, jax.Array]:
    """Raw (u, v) flow for the selected frame pairs, each f32 [B, P, h, w]
    in flow-grid pixels.

    warm_plan (key_pos, warm_pos, warm_src) enables the temporal warm
    start (sampling.flow_warm_plan): keyframe pairs solve the full pyramid,
    the rest refine their nearest key's flow at the finest level only —
    both phases stay fully batched. warm_camera="key" reuses the keyframe
    pair's camera for its warm neighbors; "init" refines it on each warm
    pair with 3 warm-started LK iterations (homography model only; with
    "affine" it behaves as "key"); "own" estimates every pair's camera."""
    b, f, h, w = gray.shape
    i0 = jnp.take(gray, pair_idx, axis=1)
    i1 = jnp.take(gray, pair_idx + 1, axis=1)
    p = pair_idx.shape[0]

    def pick(x, pos):  # [B, P, ...] -> the pairs at pos, flattened [B*n, ...]
        x = jnp.take(x, pos, axis=1)
        return x.reshape((-1,) + x.shape[2:])

    if warm_plan is None or warm_plan[1].shape[0] == 0:
        flow_fn = tvl1_warped_flow if warped else tvl1_flow
        u, v = flow_fn(i0.reshape(b * p, h, w), i1.reshape(b * p, h, w),
                       tvl1)
        return u.reshape(b, p, h, w), v.reshape(b, p, h, w)

    key_pos, warm_pos, warm_src = warm_plan
    k = key_pos.shape[0]
    m = warm_pos.shape[0]
    i0k, i1k = pick(i0, key_pos), pick(i1, key_pos)
    i0w, i1w = pick(i0, warm_pos), pick(i1, warm_pos)
    if warped:
        uk, vk, ak = tvl1_warped_flow_cam(i0k, i1k, tvl1)
        a_warm = None
        if warm_camera in ("key", "init"):
            # ak is [b*k, 2, 3] (affine) or [b*k, 3, 3] (homography model)
            a_warm = pick(ak.reshape((b, k) + ak.shape[1:]), warm_src)
    else:
        uk, vk = tvl1_flow(i0k, i1k, tvl1)
    uk = uk.reshape(b, k, h, w)
    vk = vk.reshape(b, k, h, w)
    u0, v0 = pick(uk, warm_src), pick(vk, warm_src)
    if warped:
        uw, vw = tvl1_warped_flow_warm(
            i0w, i1w, u0, v0, warm_tvl1_params(tvl1), A=a_warm,
            cam_refine_iters=3 if warm_camera == "init" else 0)
    else:
        uw, vw = tvl1_flow_warm(i0w, i1w, u0, v0, warm_tvl1_params(tvl1))
    u = jnp.zeros((b, p, h, w), uk.dtype)
    v = jnp.zeros((b, p, h, w), vk.dtype)
    u = u.at[:, key_pos].set(uk).at[:, warm_pos].set(uw.reshape(b, m, h, w))
    v = v.at[:, key_pos].set(vk).at[:, warm_pos].set(vw.reshape(b, m, h, w))
    return u, v


def _pair_flow(gray: jax.Array, pair_idx: jax.Array, bound: float,
               warped: bool, tvl1: TVL1Params,
               value_scale: tuple[float, float],
               warm_plan=None, warm_camera: str = "own") -> jax.Array:
    """Quantized flow for the selected frame pairs: u8 [B, P, h, w, 2].
    value_scale = (sx, sy) converts flow values back to native pixels (the
    flow grid may be anisotropically scaled)."""
    u, v = _pair_flow_uv(gray, pair_idx, warped, tvl1, warm_plan,
                         warm_camera)
    uv = jnp.stack([u * value_scale[0], v * value_scale[1]], axis=-1)
    return quantize_flow(uv, bound)


def _ensemble_embed(params, x_flat: jax.Array, mesh=None) -> jax.Array:
    """[K, N, 1024] embeddings of the K-member stacked ensemble.

    Single-device: vmap over the stacked params (XLA lowers the shared-input
    convs as grouped convs — fine un-partitioned). With a mesh whose model
    axis is >1: shard_map over the mesh instead, because GSPMD cannot
    partition vmap's grouped-conv lowering along a model axis that does not
    divide the conv's output channels (K=3 splits x 64-out conv1) — each
    shard runs plain convs on its local ensemble members."""
    from videoquery.core.meshes import DATA_AXIS, MODEL_AXIS
    from videoquery.nn import bn_inception

    def batched(p, x):
        k = jax.tree.leaves(p)[0].shape[0]
        return jax.vmap(bn_inception.embed)(
            p, jnp.broadcast_to(x, (k,) + x.shape))

    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) == 1:
        return jax.vmap(lambda p: bn_inception.embed(p, x_flat))(params)
    from jax.sharding import PartitionSpec as P

    return jax.shard_map(
        batched, mesh=mesh,
        in_specs=(P(MODEL_AXIS), P(DATA_AXIS)),
        out_specs=P(MODEL_AXIS, DATA_AXIS),
    )(params, x_flat)


def _yuv420_to_bgr(yuv: jax.Array) -> jax.Array:
    """I420 uint8 [..., H*3//2, W] -> float32 BGR [..., H, W, 3] in
    [0, 255], matching cv2.cvtColor(COLOR_YUV2BGR_I420) to <=2 LSB
    (tests/test_pipeline.py): nearest 2x chroma upsample + the BT.601
    studio-swing constants cv2's fixed-point path uses. Device inverse of
    decode.bgr_to_yuv420 (ExtractionConfig.host_yuv420 compact upload)."""
    hh, w = yuv.shape[-2], yuv.shape[-1]
    h = hh * 2 // 3
    lead = yuv.shape[:-2]
    y = yuv[..., :h, :].astype(jnp.float32)
    # I420 memory layout: Y [h, w], then U and V planes of [h//2, w//2]
    # each, packed row-major into (h//4) rows of width w apiece
    uv = yuv[..., h:, :].reshape(lead + (2, h // 2, w // 2))
    u = uv[..., 0, :, :].astype(jnp.float32) - 128.0
    v = uv[..., 1, :, :].astype(jnp.float32) - 128.0
    u = jnp.repeat(jnp.repeat(u, 2, axis=-2), 2, axis=-1)
    v = jnp.repeat(jnp.repeat(v, 2, axis=-2), 2, axis=-1)
    yf = 1.1643836 * (y - 16.0)
    b = yf + 2.0172321 * u
    g = yf - 0.3917623 * u - 0.8129676 * v
    r = yf + 1.5960267 * v
    return jnp.clip(jnp.stack([b, g, r], axis=-1), 0.0, 255.0)


def _flow_gray_grid(frames_u8: jax.Array, flow_res_div: int,
                    matmul: bool = True):
    """ITU-R 601 luma (BGR order, cv2 parity) + flow-grid
    resize. Returns (gray f32 [B,F,fh,fw], (vscale_x, vscale_y)).

    matmul=True folds the channel dot INTO the horizontal bilinear resize —
    the exact jax.image.resize operator is linear and separable, so its
    per-axis weight matrices are extracted by resizing an identity (constant-
    folded at compile time) and the [W,3] tail axes merge into one
    [W*3, fw] matmul. bf16 operands, f32 accumulation; gray perturbation
    < 4e-3 on the [0,1] scale — EPE-gated equal to the exact path
    (tools/flow_quality.py --gray)."""
    h0, w0 = frames_u8.shape[2:4]
    if flow_res_div <= 1:
        f32 = frames_u8.astype(jnp.float32)
        gray = (0.114 * f32[..., 0] + 0.587 * f32[..., 1]
                + 0.299 * f32[..., 2]) / 255.0
        return gray, (1.0, 1.0)
    b, f = frames_u8.shape[:2]
    # reduced grid — see flow_grid_shape. The anisotropic value scale
    # converts flow back to native pixels.
    fh, fw = flow_grid_shape(h0, w0, flow_res_div)
    if not matmul:
        f32 = frames_u8.astype(jnp.float32)
        gray = (0.114 * f32[..., 0] + 0.587 * f32[..., 1]
                + 0.299 * f32[..., 2]) / 255.0
        gray = jax.image.resize(gray, (b, f, fh, fw), method="linear")
        return gray, (w0 / fw, h0 / fh)
    rv = jax.image.resize(jnp.eye(h0, dtype=jnp.float32), (fh, h0),
                          method="linear").T             # [h0, fh]
    rh = jax.image.resize(jnp.eye(w0, dtype=jnp.float32), (fw, w0),
                          method="linear").T             # [w0, fw]
    wvec = jnp.asarray([0.114, 0.587, 0.299], jnp.float32) / 255.0
    whc = (rh[:, None, :] * wvec[None, :, None]).reshape(w0 * 3, fw)
    # bf16 operands with f32 accumulation on the accelerator (tensor
    # cores); the CPU executor has no bf16 x bf16 -> f32 dot, so tests and
    # the virtual mesh stay f32
    mm = jnp.float32 if jax.default_backend() == "cpu" else jnp.bfloat16
    x = frames_u8.reshape(b, f, h0, w0 * 3).astype(mm)
    t = jnp.einsum("bfhx,xj->bfhj", x, whc.astype(mm),
                   preferred_element_type=jnp.float32)   # [B,F,h0,fw]
    gray = jnp.einsum("bfhj,hi->bfij", t.astype(mm), rv.astype(mm),
                      preferred_element_type=jnp.float32)
    return gray, (w0 / fw, h0 / fh)


@functools.partial(
    jax.jit,
    static_argnames=("bound", "warped", "tvl1", "cfg_resize", "cfg_crop",
                     "dtype_str", "flow_res_div", "mesh",
                     "flow_warm_camera", "flow_gray_matmul", "host_cropped", "native_hw",
                     "host_yuv"),
)
def _extract_step(
    rgb_params,
    flow_params,
    frames_u8: jax.Array,     # u8 [B, F, H, W, 3] BGR
    rgb_tick_idx: jax.Array,  # i32 [T] 0-based frame indices
    stack_idx: jax.Array,     # i32 [T, D] positions into flow_pair_idx
    bound: float,
    warped: bool,
    tvl1: TVL1Params,
    cfg_resize: tuple[int, int],
    cfg_crop: int,
    dtype_str: str,
    flow_pair_idx: jax.Array,  # i32 [P] frame pairs to solve (flow_pair_plan)
    flow_res_div: int = 1,
    mesh=None,  # jax Mesh when the ensemble shards over a model axis
    flow_warm_plan=None,  # (key_pos, warm_pos, warm_src) i32 arrays from
                          # sampling.flow_warm_plan (temporal warm start)
    flow_warm_camera: str = "own",  # camera of warm pairs (see
                                    # _pair_flow_uv.warm_camera)
    flow_gray_matmul: bool = True,  # fold gray into the flow-grid resize
                                    # as bf16 matmuls (EPE-gated)
    gray_u8: jax.Array | None = None,  # u8 [B, F, fh, fw] host-computed
                                       # gray at the flow grid (compact
                                       # upload: frames_u8 then holds ONLY
                                       # the tick frames [B, T, H, W, 3])
    host_cropped: bool = False,  # tick frames arrive already resized +
                                 # cropped (decode.resize_crop_frames;
                                 # ExtractionConfig.host_crop) — the rgb
                                 # preprocess skips its resize+crop
    native_hw: tuple[int, int] | None = None,  # (H, W) of the frames the
                                 # gray grid was computed from — REQUIRED
                                 # with host_cropped (the cropped tick
                                 # frames no longer carry it); sets the
                                 # flow-grid -> native-pixel value scale
    host_yuv: bool = False,      # tick frames arrive as I420 YUV 4:2:0
                                 # [B, T, crop*3//2, crop] uint8
                                 # (decode.bgr_to_yuv420;
                                 # ExtractionConfig.host_yuv420) — BGR is
                                 # reconstructed on device
):
    """The whole per-batch extraction as ONE device program:
    grayscale -> warped TV-L1 -> tick gather -> preprocess -> 6-way TSN.

    Everything stays in device memory; the only outputs are the
    [K, B, 1024] embeddings per stream. Flow is solved only for the frame
    pairs the tick stacks consume (flow_pair_idx), so stack_idx holds
    positions into that pair list.

    With gray_u8 (ExtractionConfig.host_gray), grayscale + flow-grid resize
    move to the host decoder and the upload shrinks ~4x: 25 tick frames +
    uint8 gray instead of all 150 RGB frames per clip. uint8 gray is what
    the reference's dense_flow consumed (build_wof_clips.py:60-73 feeds it
    cv2 gray JPEGs), so the quantization is parity, not loss."""
    from videoquery.nn import bn_inception

    if gray_u8 is not None:
        if native_hw is not None:
            h0, w0 = native_hw
        else:
            if host_cropped:
                raise ValueError("host_cropped needs native_hw: the cropped "
                                 "tick frames no longer carry the native "
                                 "size the flow values must scale to")
            h0, w0 = frames_u8.shape[2], frames_u8.shape[3]
        fh, fw = gray_u8.shape[2], gray_u8.shape[3]
        gray = gray_u8.astype(jnp.float32) / 255.0
        vscale = (w0 / fw, h0 / fh)
    else:
        gray, vscale = _flow_gray_grid(frames_u8, flow_res_div,
                                       matmul=flow_gray_matmul)
    flow_q = _pair_flow(gray, flow_pair_idx, bound, warped, tvl1, vscale,
                        flow_warm_plan, flow_warm_camera)  # u8 [B,P,fh,fw,2]

    if gray_u8 is not None:
        rgb_ticks = frames_u8  # host already gathered the tick frames
        if host_yuv:
            rgb_ticks = _yuv420_to_bgr(rgb_ticks)  # f32 [B,T,crop,crop,3]
    else:
        rgb_ticks = jnp.take(frames_u8, rgb_tick_idx, axis=1)  # [B,T,H,W,3]
    stacks = jnp.take(flow_q, stack_idx.reshape(-1), axis=1)
    b = frames_u8.shape[0]
    t, d = stack_idx.shape
    h, w = flow_q.shape[2:4]   # flow may be at reduced resolution
    stacks = stacks.reshape(b, t, d, h, w, 2)
    # interleave x/y per depth -> channels [x1, y1, ..., xD, yD]
    stacks = stacks.transpose(0, 1, 3, 4, 2, 5).reshape(b, t, h, w, d * 2)

    dtype = jnp.dtype(dtype_str)
    rgb_in = preprocess_rgb(rgb_ticks, cfg_resize, cfg_crop, dtype=dtype,
                            precropped=host_cropped)
    flow_in = preprocess_flow(stacks, cfg_resize, cfg_crop, dtype=dtype)
    rgb_flat = rgb_in.reshape((b * t,) + rgb_in.shape[2:])
    flow_flat = flow_in.reshape((b * t,) + flow_in.shape[2:])
    rgb_emb = _ensemble_embed(rgb_params, rgb_flat, mesh)
    flow_emb = _ensemble_embed(flow_params, flow_flat, mesh)
    k = rgb_emb.shape[0]
    return (
        rgb_emb.reshape(k, b, t, -1).mean(axis=2),
        flow_emb.reshape(k, b, t, -1).mean(axis=2),
    )


@dataclasses.dataclass
class ClipSignatures:
    """Per-batch signatures. rgb/flow may be device arrays (deferred
    readback, batched over many clip batches; materialize() or
    gather_signatures() downloads)."""

    clip_numbers: list[int]
    rgb: "np.ndarray | jax.Array"   # [K, B, 1024]
    flow: "np.ndarray | jax.Array"  # [K, B, 1024]
    splits: tuple[int, ...]

    def materialize(self) -> "ClipSignatures":
        return ClipSignatures(
            self.clip_numbers,
            np.asarray(self.rgb, np.float32),
            np.asarray(self.flow, np.float32),
            self.splits,
        )


def gather_signatures(sigs: list[ClipSignatures]) -> list[ClipSignatures]:
    """Download a list of (possibly device-resident) signatures with ONE
    device->host transfer instead of 2 per batch."""
    device = [s for s in sigs if not isinstance(s.rgb, np.ndarray)]
    if not device:
        return sigs
    flat = jnp.concatenate(
        [jnp.stack([s.rgb, s.flow]).reshape(2, s.rgb.shape[0], -1)
         for s in device],
        axis=2,
    )  # [2, K, sum(B)*1024]
    host = np.asarray(flat, np.float32)
    out = []
    offset = 0
    di = 0
    for s in sigs:
        if isinstance(s.rgb, np.ndarray):
            out.append(s)
            continue
        k, b, d = s.rgb.shape
        chunk = host[:, :, offset:offset + b * d].reshape(2, k, b, d)
        out.append(ClipSignatures(s.clip_numbers, chunk[0], chunk[1], s.splits))
        offset += b * d
        di += 1
    return out


class Extractor:
    """Two-stream signature extractor.

    With a mesh, clip batches shard over the "data" axis and the split
    ensemble over the "model" axis (batch_clips should be a multiple of the
    data-axis size; SURVEY.md §2.3's device mapping of the reference's
    multiprocessing pools)."""

    def __init__(self, tsn: TwoStreamTSN, cfg: ExtractionConfig | None = None,
                 warped: bool = True, dtype: str = "float32",
                 tvl1: TVL1Params | None = None, mesh=None):
        self.tsn = tsn
        self.cfg = cfg or ExtractionConfig()
        self.warped = warped
        self.dtype = dtype
        self.tvl1 = tvl1 or PRODUCTION_TVL1
        if (self.cfg.flow_warm_camera == "init"
                and self.tvl1.camera_model != "homography"):
            # warm camera refinement is only implemented for the 3x3
            # homography model (tvl1_warped_flow_warm checks
            # A.shape[-2] == 3); with 'affine' the config silently degrades
            # to 'key' (stale cameras) — surface that instead of hiding it
            log.warning(
                "flow_warm_camera='init' requires camera_model='homography' "
                "(got %r); warm groups will reuse the stale key camera "
                "('key' behavior)", self.tvl1.camera_model)
        self.flow_res_div = self.cfg.flow_res_div
        self.mesh = mesh
        self._plan_cache: dict[int, tuple] = {}
        self._frame_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from videoquery.core.meshes import DATA_AXIS, MODEL_AXIS

            self._frame_sharding = NamedSharding(mesh, P(DATA_AXIS))
            if mesh.shape.get(MODEL_AXIS, 1) > 1:
                model_sh = NamedSharding(mesh, P(MODEL_AXIS))
                self.tsn = TwoStreamTSN(
                    dataclasses.replace(
                        tsn.rgb,
                        stacked_params=jax.device_put(tsn.rgb.stacked_params,
                                                      model_sh)),
                    dataclasses.replace(
                        tsn.flow,
                        stacked_params=jax.device_put(tsn.flow.stacked_params,
                                                      model_sh)),
                )

    def _plan_groups(self, n_frames: int, clip_numbers=None):
        return plan_groups(n_frames, self.cfg, clip_numbers)

    def extract_frames(self, frames: np.ndarray, clip_numbers=None
                       ) -> Iterator[ClipSignatures]:
        """frames: BGR uint8 [N, H, W, 3] for a whole video. Yields batches
        of per-clip signatures."""
        for group, nums in self._plan_groups(len(frames), clip_numbers):
            yield self._signature_batch(frames, None, group, nums)

    def extract_video_stream(self, path: str,
                             new_size: tuple[int, int] | None = None
                             ) -> list[ClipSignatures]:
        """Overlap host decode with device extraction: a producer thread
        runs stream_payloads (decode + gray + payload build; cv2 releases
        the GIL so it overlaps the main thread's uploads/dispatch on 2+
        core hosts) while this thread uploads and dispatches device batches
        — end-to-end wall clock approaches max(decode, upload, device)
        instead of their sum (the reference ran its stages strictly
        sequentially, build_wof_clips.py:175-189).

        Memory is CONSTANT in video length: stream_payloads holds one
        frame window (clip batches consume monotonically increasing frame
        ranges), and the bounded queue here backpressures a fast decoder
        against a slow device/upload — peak host RAM is a few batch
        payloads instead of the whole decoded video (a 1 h 15 fps video is
        ~14 GB; the reference spilled frames/flow to JPEG trees on disk,
        build_wof_clips.py:44-100). For multi-CORE hosts see
        pipeline/mpstream.py (worker processes, one video each)."""
        import queue
        import threading

        if new_size is None:
            new_size = self._decode_size()
        q: "queue.Queue" = queue.Queue(
            maxsize=max(2, self.cfg.stream_window_batches))
        _END = object()

        def producer():
            try:
                for payload in stream_payloads(path, self.cfg,
                                               self.flow_res_div, new_size):
                    q.put(payload)
                q.put(_END)
            except BaseException as exc:  # surface decode errors
                q.put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        sigs: list[ClipSignatures] = []
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                # a decode failure must never silently truncate a video's
                # feature set — extract_video propagates too (parity)
                raise item
            sigs.append(self._dispatch_payload(item))
        t.join()
        sigs.sort(key=lambda s: s.clip_numbers[0])
        return gather_signatures(sigs)

    def _plan_arrays(self, f_len: int):
        """Tick/stack/pair/warm index arrays for a clip length, device-
        resident and CACHED: the plan depends only on (f_len, cfg), which is
        constant across batches and videos, so each batch skips five small
        index uploads."""
        cfg = self.cfg
        hit = self._plan_cache.get(f_len)
        if hit is not None:
            return hit
        ticks_rgb = frame_ticks(f_len, cfg.num_ticks, 1)             # 1-based
        pair_idx, stack_pos = flow_pair_plan(
            f_len, cfg.num_ticks, cfg.flow_stack_depth)
        warm = None
        if cfg.flow_warm_group > 1:
            key_pos, warm_pos, warm_src = flow_warm_plan(
                pair_idx, cfg.flow_warm_group)
            if warm_pos.size:
                warm = (jnp.asarray(key_pos), jnp.asarray(warm_pos),
                        jnp.asarray(warm_src))
        plan = (ticks_rgb,
                jnp.asarray(ticks_rgb - 1, jnp.int32),
                jnp.asarray(stack_pos, jnp.int32),
                jnp.asarray(pair_idx, jnp.int32),
                warm)
        self._plan_cache[f_len] = plan
        return plan

    def _signature_batch(self, frames, gray, group, nums) -> ClipSignatures:
        """Host payload build + device dispatch for one clip batch (see
        build_payload for the upload-layout documentation)."""
        return self._dispatch_payload(
            build_payload(frames, gray, group, nums, self.cfg,
                          self.flow_res_div))

    def _dispatch_payload(self, payload: BatchPayload) -> ClipSignatures:
        """The device half: upload a host-built payload and run the fused
        extraction step. Payloads may come from this process's producer
        thread (extract_video_stream) or from decode worker processes
        (pipeline/mpstream.py)."""
        cfg = self.cfg
        nums = payload.nums
        clip_rgb = payload.clip_rgb
        gray_np = payload.gray
        native_hw = payload.native_hw
        _ticks_rgb, ticks_dev, stack_dev, pair_dev, warm = \
            self._plan_arrays(payload.f_len)
        gray_dev = None
        if gray_np is not None and self._frame_sharding is None:
            # both payloads are uint8: pack them into ONE transfer
            # (core/transfer.py)
            from videoquery.core.transfer import device_put_tree

            frames_dev, gray_dev = device_put_tree((clip_rgb, gray_np))
        else:
            frames_dev = jnp.asarray(clip_rgb)
            if gray_np is not None:
                gray_dev = jnp.asarray(gray_np)
            if self._frame_sharding is not None:
                frames_dev = jax.device_put(frames_dev, self._frame_sharding)
                if gray_dev is not None:
                    gray_dev = jax.device_put(gray_dev, self._frame_sharding)
        rgb_emb, flow_emb = _extract_step(
            self.tsn.rgb.stacked_params,
            self.tsn.flow.stacked_params,
            frames_dev,
            ticks_dev,
            stack_dev,
            cfg.flow_bound,
            self.warped,
            self.tvl1,
            cfg.frame_resize,
            cfg.crop_size,
            self.dtype,
            pair_dev,
            self.flow_res_div,
            mesh=self.mesh,
            flow_warm_plan=warm,
            flow_warm_camera=cfg.flow_warm_camera,
            flow_gray_matmul=cfg.flow_gray_matmul,
            gray_u8=gray_dev,
            host_cropped=cfg.host_crop,
            native_hw=native_hw,
            host_yuv=cfg.host_yuv420,
        )
        # keep embeddings on device: callers batch the readback
        # (gather_signatures)
        return ClipSignatures(nums, rgb_emb, flow_emb, self.tsn.rgb.splits)

    def extract_videos(self, paths, workers: int = 0, new_size=None):
        """Multi-video extraction with a multi-PROCESS decode producer
        (pipeline/mpstream.py) — {path: [ClipSignatures]}. workers=0 picks
        cpu_count-1. The multi-core rebirth of the reference's Pool over
        videos (build_wof_clips.py:175-184)."""
        from videoquery.pipeline.mpstream import extract_videos_mp

        return extract_videos_mp(self, paths, workers=workers,
                                 new_size=new_size)

    def _decode_size(self) -> tuple[int, int] | None:
        """(W, H) to decode at — frame_resize when decode_at_target (one
        cv2 resize at decode, device geometry fixed across input
        resolutions), else native."""
        return self.cfg.frame_resize if self.cfg.decode_at_target else None

    def extract_video(self, path: str) -> list[ClipSignatures]:
        frames = decode.load_video(path, new_size=self._decode_size())
        return gather_signatures(list(self.extract_frames(frames)))

    # -- reference-format CSV output (calcSig_wOF.py:116-134 layout) ---------

    def write_csv_tree(self, signatures: list[ClipSignatures], out_dir: str,
                       video: str, video_url: str,
                       modelname_fmt: str = "UCF101_split{split}",
                       weights_uri_fmt: str = "ucf101_split{split}_tsn_{stream}_bn_inception.npz",
                       ) -> list[str]:
        """One CSV per (split, stream) under <out>/<video>/<modelname>/."""
        if not signatures:  # video too short to yield any clip
            return []
        signatures = gather_signatures(signatures)
        paths = []
        for ki, split in enumerate(signatures[0].splits):
            d = os.path.join(out_dir, video, modelname_fmt.format(split=split))
            os.makedirs(d, exist_ok=True)
            for stream, attr in ((RGB, "rgb"), (FLOW, "flow")):
                rows = []
                for sig in signatures:
                    emb = getattr(sig, attr)[ki]
                    rows.extend(zip(sig.clip_numbers, emb))
                rows.sort(key=lambda r: r[0])
                path = os.path.join(d, f"{stream}_{self.cfg.feature_blob}_features.csv")
                write_features_csv(
                    path, video, video_url, stream, self.cfg.feature_blob,
                    weights_uri_fmt.format(split=split, stream=attr), rows,
                )
                paths.append(path)
        return paths

    def records(self, signatures: list[ClipSignatures],
                clip_id_of: dict[int, int] | None = None) -> list[FeatureRecord]:
        signatures = gather_signatures(signatures)
        out = []
        for sig in signatures:
            for ki, split in enumerate(sig.splits):
                for bi, clip_no in enumerate(sig.clip_numbers):
                    cid = clip_id_of[clip_no] if clip_id_of else clip_no
                    out.append(FeatureRecord(cid, RGB, split,
                                             self.cfg.feature_blob, sig.rgb[ki, bi]))
                    out.append(FeatureRecord(cid, FLOW, split,
                                             self.cfg.feature_blob, sig.flow[ki, bi]))
        return out


def main(argv=None) -> None:
    """CLI: extract features for every video in a directory (the
    build_wof_clips + calcSig_wOF + ensemble driver rolled into one)."""
    import argparse
    import glob

    from videoquery.nn.tsn import StreamEnsemble, TwoStreamTSN
    from videoquery.nn import bn_inception

    p = argparse.ArgumentParser(description="Two-stream TSN feature extraction")
    p.add_argument("src", help="video file, directory of videos, or 'synthetic'")
    p.add_argument("--out", required=True, help="output feature-CSV tree root")
    p.add_argument("--weights", default=None,
                   help="npz weight bundle dir (from convert_caffe); random if omitted")
    p.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--num_ticks", type=int, default=25)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--clip_time", type=int, default=10)
    p.add_argument("--batch_clips", type=int, default=4)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--no-warp", action="store_true", help="plain (unwarped) TV-L1")
    p.add_argument("--ext", default="mp4")
    # reference-CLI parity flags (calcSig_wOF.py:156-177, build_wof_clips.py:133-150)
    p.add_argument("--featureBlob", default="global_pool",
                   help="feature blob name recorded in the CSVs")
    p.add_argument("--modelname", default="UCF101_split{split}",
                   help="per-split model dir name template")
    p.add_argument("--new_width", type=int, default=0, help="decode resize width")
    p.add_argument("--new_height", type=int, default=0, help="decode resize height")
    p.add_argument("--flow_res_div", type=int, default=2,
                   help="compute flow at frame_res/div (speed/quality knob)")
    p.add_argument("--host_gray", action="store_true",
                   help="compact upload: host cv2 gray + tick frames only "
                        "(~4x fewer host->device bytes; see "
                        "ExtractionConfig.host_gray)")
    p.add_argument("--host_crop", action="store_true",
                   help="with --host_gray: resize+crop tick frames on the "
                        "host too (~42%% fewer rgb bytes; see "
                        "ExtractionConfig.host_crop)")
    p.add_argument("--host_yuv420", action="store_true",
                   help="with --host_crop: ship tick frames as YUV 4:2:0 "
                        "(1.5 B/px; the reference's own rgb inputs went "
                        "through 4:2:0 JPEGs) and reconstruct BGR on "
                        "device (ExtractionConfig.host_yuv420)")
    p.add_argument("--workers", type=int, default=1,
                   help="decode worker PROCESSES (>1: multi-core streaming "
                        "producer, pipeline/mpstream.py; the reference's "
                        "num_worker Pool, build_wof_clips.py:175-184)")
    args = p.parse_args(argv)

    from videoquery.core.jaxsetup import setup_jax

    setup_jax()

    cfg = ExtractionConfig(fps=args.fps, clip_seconds=args.clip_time,
                           num_ticks=args.num_ticks, batch_clips=args.batch_clips,
                           feature_blob=args.featureBlob,
                           flow_res_div=args.flow_res_div,
                           host_gray=args.host_gray,
                           host_crop=args.host_crop,
                           host_yuv420=args.host_yuv420)

    # resolve inputs BEFORE building the model: a bad path should fail
    # before the TSN is built and compiled
    if args.src == "synthetic":
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "_synthetic.mp4")
        decode.synthesize_video(path, n_frames=320)
        videos = [path]
    elif os.path.isdir(args.src):
        videos = sorted(glob.glob(os.path.join(args.src, f"*.{args.ext}")))
        if not videos:
            raise SystemExit(f"no *.{args.ext} videos in {args.src!r}")
    elif os.path.isfile(args.src):
        videos = [args.src]
    else:
        raise SystemExit(f"input not found: {args.src!r}")

    if args.weights:
        from videoquery.nn.convert_caffe import load_npz

        rgb = {s: load_npz(os.path.join(args.weights, f"rgb_split{s}.npz"))
               for s in args.splits}
        flow = {s: load_npz(os.path.join(args.weights, f"flow_split{s}.npz"))
                for s in args.splits}
        tsn = TwoStreamTSN(
            StreamEnsemble.from_split_params(
                {k: jax.tree.map(jnp.asarray, v) for k, v in rgb.items()},
                bn_inception.RGB_CHANNELS),
            StreamEnsemble.from_split_params(
                {k: jax.tree.map(jnp.asarray, v) for k, v in flow.items()},
                bn_inception.FLOW_CHANNELS),
        )
    else:
        log.warning("no --weights: using random-initialized TSN (pipeline demo)")
        tsn = TwoStreamTSN.random(jax.random.PRNGKey(0), tuple(args.splits))

    new_size = None
    if args.new_width or args.new_height:
        if not (args.new_width and args.new_height):
            raise SystemExit("--new_width and --new_height must be set together")
        new_size = (args.new_width, args.new_height)

    ex = Extractor(tsn, cfg, warped=not args.no_warp, dtype=args.dtype)

    if args.workers > 1 and len(videos) > 1:
        # multi-core streaming producer: worker processes decode distinct
        # videos while this process uploads/dispatches device batches
        t0 = time.time()
        by_path = ex.extract_videos(videos, workers=args.workers,
                                    new_size=new_size)
        for vid in videos:
            name = os.path.splitext(os.path.basename(vid))[0]
            sigs = by_path[vid]
            if not sigs:
                log.warning("%s: too short for any clip; skipped", name)
                continue
            ex.write_csv_tree(sigs, args.out, name, vid,
                              modelname_fmt=args.modelname)
        n_clips = sum(len(s.clip_numbers) for sg in by_path.values()
                      for s in sg)
        dt = time.time() - t0
        print(f"{len(videos)} videos, {n_clips} clips in {dt:.1f}s "
              f"({n_clips/dt:.2f} clips/s, {args.workers} decode workers)")
        return

    # prefetch: decode video i+1 on a host thread while the device extracts
    # video i (cv2 decode is host-bound; extraction is device-bound)
    from concurrent.futures import ThreadPoolExecutor

    decoder = ThreadPoolExecutor(max_workers=1)
    futures = {videos[0]: decoder.submit(decode.load_video_parallel, videos[0],
                                         new_size=new_size)} if videos else {}
    for i, vid in enumerate(videos):
        if i + 1 < len(videos):
            futures[videos[i + 1]] = decoder.submit(
                decode.load_video_parallel, videos[i + 1], new_size=new_size)
        name = os.path.splitext(os.path.basename(vid))[0]
        t0 = time.time()
        frames = futures.pop(vid).result()
        sigs = gather_signatures(list(ex.extract_frames(frames)))
        if not sigs:
            log.warning("%s: too short for any clip (%d frames); skipped",
                        name, len(frames))
            continue
        n_clips = sum(len(s.clip_numbers) for s in sigs)
        dt = time.time() - t0
        ex.write_csv_tree(sigs, args.out, name, vid,
                          modelname_fmt=args.modelname)
        log.info("%s: %d clips in %.1fs (%.2f clips/s)", name, n_clips, dt,
                 n_clips / dt)
        print(f"{name}: {n_clips} clips in {dt:.1f}s ({n_clips/dt:.2f} clips/s)")
    decoder.shutdown(wait=False)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
