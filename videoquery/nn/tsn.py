"""Temporal Segment Networks: two-stream ensemble over BN-Inception.

The reference scores a clip with 6 CNNs — 2 streams (rgb, warped optical
flow) x 3 UCF101 training splits — each applied to 25 sampled ticks and
averaged (calcSig_wOF.py:59-113, calcSig_wOF_ensemble.sh:12-37). The
reference runs these as 6 separate Caffe processes; here each stream's
3-split ensemble is a *stacked* parameter pytree vmapped into one XLA
program, so one device call embeds [splits, ticks, H, W, C] at once
(SURVEY.md §2.3 "ensemble parallelism").

The rgb and flow networks keep separate programs (3- vs 10-channel input —
padding them together would waste matrix-unit work; SURVEY.md §7 'hard
parts').
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping

import jax
import jax.numpy as jnp

from videoquery.nn import bn_inception


def stack_params(params_list: list[Mapping], device_put: bool = True) -> Any:
    """Stack per-split parameter pytrees along a new leading axis.

    Stacking happens on host (numpy) and the tree transfers as ONE packed
    buffer instead of one transfer per leaf (140 leaves)."""
    import numpy as np

    from videoquery.core.transfer import device_put_tree

    stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *params_list)
    return device_put_tree(stacked) if device_put else stacked


@functools.partial(jax.jit, static_argnames=())
def _embed_ensemble(stacked_params, frames: jax.Array) -> jax.Array:
    """frames: [B, H, W, C] -> embeddings [K, B, 1024] for K stacked splits."""
    return jax.vmap(lambda p: bn_inception.embed(p, frames))(stacked_params)


@jax.jit
def _embed_single(params, frames: jax.Array) -> jax.Array:
    return bn_inception.embed(params, frames)


@dataclasses.dataclass
class StreamEnsemble:
    """One stream's K-split ensemble (stacked params)."""

    stacked_params: Any           # pytree with leading K axis
    splits: tuple[int, ...]       # e.g. (1, 2, 3)
    in_channels: int

    @staticmethod
    def from_split_params(split_params: dict[int, Mapping], in_channels: int
                          ) -> "StreamEnsemble":
        splits = tuple(sorted(split_params))
        return StreamEnsemble(
            stack_params([split_params[s] for s in splits]), splits, in_channels
        )

    @staticmethod
    def random(key: jax.Array, in_channels: int, splits=(1, 2, 3),
               dtype=jnp.float32) -> "StreamEnsemble":
        keys = jax.random.split(key, len(splits))
        return StreamEnsemble.from_split_params(
            {s: bn_inception.init_params(k, in_channels, dtype=dtype)
             for s, k in zip(splits, keys)},
            in_channels,
        )

    def embed(self, frames: jax.Array) -> jax.Array:
        """[B, H, W, C] -> [K, B, 1024]."""
        return _embed_ensemble(self.stacked_params, frames)


@dataclasses.dataclass
class TwoStreamTSN:
    """The full 6-member signature model."""

    rgb: StreamEnsemble
    flow: StreamEnsemble

    @staticmethod
    def random(key: jax.Array, splits=(1, 2, 3), dtype=jnp.float32) -> "TwoStreamTSN":
        k1, k2 = jax.random.split(key)
        return TwoStreamTSN(
            StreamEnsemble.random(k1, bn_inception.RGB_CHANNELS, splits, dtype),
            StreamEnsemble.random(k2, bn_inception.FLOW_CHANNELS, splits, dtype),
        )

    def clip_signature(
        self, rgb_ticks: jax.Array, flow_stacks: jax.Array
    ) -> dict[str, jax.Array]:
        """Signature of one clip batch.

        rgb_ticks:   [B, T, H, W, 3]  T sampled frames per clip
        flow_stacks: [B, T, H, W, 10] T flow stacks per clip
        Returns {'rgb': [K, B, 1024], 'warped_optical_flow': [K, B, 1024]} —
        per-(split, clip) embeddings averaged over the T ticks
        (calcSig_wOF.py:82).
        """
        b, t = rgb_ticks.shape[:2]
        rgb = self.rgb.embed(rgb_ticks.reshape((b * t,) + rgb_ticks.shape[2:]))
        flow = self.flow.embed(flow_stacks.reshape((b * t,) + flow_stacks.shape[2:]))
        k = rgb.shape[0]
        return {
            "rgb": rgb.reshape(k, b, t, -1).mean(axis=2),
            "warped_optical_flow": flow.reshape(k, b, t, -1).mean(axis=2),
        }
