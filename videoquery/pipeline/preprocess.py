"""On-device preprocessing for the two TSN streams.

The reference preprocesses inside caffe-action's CaffeNet:
predict_single_frame resizes the BGR frame to (340, 256), crops, and
subtracts the ImageNet BGR means; predict_single_flow_stack does the same
for 10-channel flow stacks with mean 128 (calcSig_wOF.py:94,111 — the
implementation lives in the external TSN repo). Here the resize / crop /
normalize runs in XLA, fused into the CNN program.

Crop policy: the reference's `blobs[...].data[0]` takes the FIRST element of
the oversampled crop batch (calcSig_wOF.py:95,112), i.e. a single fixed
corner crop. We default to the center crop (the canonical TSN test-time
choice) and expose `crop="tl"` for the reference's literal first-crop
behavior; at embedding level the difference is well under ranking tolerance
for 10 s clips, and the fixture CSVs are the ground truth either way.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Caffe/TSN ImageNet means, BGR channel order.
BGR_MEAN = (104.0, 117.0, 123.0)
FLOW_MEAN = 128.0


@functools.lru_cache(maxsize=64)
def _cv2_linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] interpolation matrix reproducing cv2.resize
    INTER_LINEAR along one axis: half-pixel source coordinates
    src = (dst + 0.5) * n_in / n_out - 0.5, edge-clamped, and — unlike
    jax.image.resize — NO antialiasing filter on downscale (cv2 samples
    exactly two taps regardless of scale). The reference resizes every
    frame and flow stack with cv2 inside caffe-action
    (calcSig_wOF.py:94,111), so this is the parity-normative kernel."""
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    f = src - i0
    f = np.where(i0 < 0, 0.0, f)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    a = np.zeros((n_out, n_in), np.float64)
    a[dst.astype(np.int64), i0] += 1.0 - f
    a[dst.astype(np.int64), i1] += f
    return a.astype(np.float32)


def _resize(x: jax.Array, w: int, h: int) -> jax.Array:
    """Bilinear resize of [..., H, W, C] to (H=h, W=w), numerically matching
    cv2.resize(..., (w, h)) on float input (tested against a cv2 oracle in
    tests/test_pipeline.py). Expressed as two small matmuls, separable
    exactly as cv2's kernel is."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    if (h_in, w_in) == (h, w):
        return x
    ah = jnp.asarray(_cv2_linear_matrix(h_in, h))   # [h, h_in]
    aw = jnp.asarray(_cv2_linear_matrix(w_in, w))   # [w, w_in]
    # HIGHEST: at a reduced default matmul precision (TF32 on the GPU) the resize would
    # drift ~1 uint8 LSB from the cv2 oracle; these matrices are tiny, the
    # f32 pass costs nothing measurable.
    hi = jax.lax.Precision.HIGHEST
    x = jnp.einsum("oH,...HWc->...oWc", ah, x, precision=hi)
    return jnp.einsum("oW,...HWc->...Hoc", aw, x, precision=hi)


def _crop_origin(h: int, w: int, size: int, where: str) -> tuple[int, int]:
    if where == "center":
        return (h - size) // 2, (w - size) // 2
    if where == "tl":
        return 0, 0
    raise ValueError(f"unknown crop {where!r}")


def _crop(x: jax.Array, size: int, where: str) -> jax.Array:
    h, w = x.shape[-3], x.shape[-2]
    top, left = _crop_origin(h, w, size, where)
    return x[..., top:top + size, left:left + size, :]


def _resize_crop(x: jax.Array, w: int, h: int, size: int,
                 where: str) -> jax.Array:
    """resize-to-(w,h) followed by a size x size crop, computed as ONE pair
    of matmuls over the SLICED interpolation matrices: cropping the output
    of a separable resize == resizing with the crop window's matrix rows,
    so only the kept pixels are ever computed (identical values; ~40% fewer
    FLOPs and no [.., h, w, c] intermediate at production geometry)."""
    top, left = _crop_origin(h, w, size, where)
    h_in, w_in = x.shape[-3], x.shape[-2]
    x = x.astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    if h_in != h:
        ah = jnp.asarray(_cv2_linear_matrix(h_in, h)[top:top + size])
        x = jnp.einsum("oH,...HWc->...oWc", ah, x, precision=hi)
    else:
        x = x[..., top:top + size, :, :]
    if w_in != w:
        aw = jnp.asarray(_cv2_linear_matrix(w_in, w)[left:left + size])
        x = jnp.einsum("oW,...HWc->...Hoc", aw, x, precision=hi)
    else:
        x = x[..., left:left + size, :]
    return x


def preprocess_rgb(
    frames: jax.Array,            # [..., H, W, 3] BGR uint8/float
    resize_wh: tuple[int, int] = (340, 256),
    crop_size: int = 224,
    crop: str = "center",
    dtype=jnp.float32,
    precropped: bool = False,     # frames already resized+cropped on host
) -> jax.Array:
    """BGR frames -> mean-subtracted crops ready for the rgb net.

    precropped: the host already applied the cv2 resize + crop
    (decode.resize_crop_frames, ExtractionConfig.host_crop) — only the
    mean subtraction remains on device."""
    if precropped:
        x = frames.astype(jnp.float32)
    else:
        x = _resize_crop(frames, resize_wh[0], resize_wh[1], crop_size, crop)
    x = x - jnp.asarray(BGR_MEAN, jnp.float32)
    return x.astype(dtype)


def preprocess_flow(
    stacks: jax.Array,            # [..., H, W, 10] interleaved x/y flow images
    resize_wh: tuple[int, int] = (340, 256),
    crop_size: int = 224,
    crop: str = "center",
    dtype=jnp.float32,
) -> jax.Array:
    """Quantized flow stacks (0..255, 128 = zero motion) -> net input."""
    x = _resize_crop(stacks, resize_wh[0], resize_wh[1], crop_size, crop)
    x = x - FLOW_MEAN
    return x.astype(dtype)


def quantize_flow(flow: jax.Array, bound: float = 20.0) -> jax.Array:
    """dense_flow's 8-bit flow quantization: clip to [-bound, bound] and map
    to [0, 255] (build_wof_clips.py:70-73 passes -b 20). Kept for CSV/JPEG
    interchange with the reference; the native pipeline can feed float flow
    straight through dequantize-free."""
    x = jnp.clip(flow, -bound, bound)
    return jnp.round((x + bound) * (255.0 / (2.0 * bound))).astype(jnp.uint8)


def dequantize_flow(q: jax.Array, bound: float = 20.0) -> jax.Array:
    return q.astype(jnp.float32) * (2.0 * bound / 255.0) - bound
