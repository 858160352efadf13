"""Seeded synthetic video for benchmarks and the chip smoke test (numpy
only: no cv2, no jax).

Coherent multi-scale textures under a camera pan with one moving object —
the flow-quality corpus recipe at production geometry. This is the
representative extraction input: uniform noise makes every pair's solved
flow garbage and hands warm starts a useless initializer, a worst case no
real video resembles."""

from __future__ import annotations

import numpy as np


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] linear-interpolation weights (pixel-center aligned)."""
    x = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = x - i0
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), i0), 1.0 - frac)
    np.add.at(m, (np.arange(n_out), i1), frac)
    return m


def texture(rng, h: int, w: int, cell: int) -> np.ndarray:
    """uint8 [h, w, 3]: random values on a `cell`-pixel grid, upsampled
    bilinearly and stretched to the full 0..255 range."""
    grid = rng.random((h // cell + 2, w // cell + 2, 3))
    gh, gw = grid.shape[:2]
    rows = (_interp_matrix(h, gh) @ grid.reshape(gh, gw * 3)).reshape(h, gw, 3)
    t = np.einsum("wj,hjc->hwc", _interp_matrix(w, gw), rows, optimize=True)
    t -= t.min()
    return (t / max(t.max(), 1e-9) * 255).astype(np.uint8)


def _pingpong(x: float, lim: int) -> int:
    # reflect instead of wrap: a modulo wrap is a scene cut, rare in real
    # clips and not representative
    x = int(abs(x)) % (2 * lim)
    return x if x < lim else 2 * lim - 1 - x


def textured_motion_video(n_frames: int, h: int, w: int, rng,
                          obj_size: int = 48) -> np.ndarray:
    """BGR uint8 [n_frames, h, w, 3]: one scene — a panning camera over a
    two-scale texture plus an independently moving textured object."""
    base = texture(rng, 2 * h, 2 * w, 24) // 2 + texture(rng, 2 * h, 2 * w, 6) // 2
    obj = texture(rng, obj_size, obj_size, 8)
    pvx, pvy = rng.uniform(0.5, 2.5), rng.uniform(-1.0, 1.0)
    ovx, ovy = rng.uniform(-4.0, 4.0), rng.uniform(-3.0, 3.0)
    out = np.empty((n_frames, h, w, 3), np.uint8)
    for t in range(n_frames):
        ox, oy = _pingpong(t * pvx, w), _pingpong(t * pvy, h)
        out[t] = base[oy:oy + h, ox:ox + w]
        px = _pingpong(60 + t * ovx, w - obj_size)
        py = _pingpong(40 + t * ovy, h - obj_size)
        out[t, py:py + obj_size, px:px + obj_size] = obj
    return out


def textured_motion_clips(batch: int, frames: int, h: int, w: int,
                          rng) -> np.ndarray:
    """uint8 [batch, frames, h, w, 3]: one independent scene per clip."""
    return np.stack([textured_motion_video(frames, h, w, rng)
                     for _ in range(batch)])
