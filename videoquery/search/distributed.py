"""Sharded multi-query search: the 1M-segment serving path.

The broker-compat engine (videoquery.search.engine) scores one target over
one search set. This module is the scale path (BASELINE.json configs 4-5):
the index is sharded over the "data" mesh axis, Q query targets are scored
against all N segments in one SPMD program (shard_map), each shard computes
its local top-k, and a single all-gather of Q x k candidates per shard —
not the N-sized score matrix — crosses the interconnect (NCCL over
NVLink, where every card reaches every other at the same rate); the host
only ever sees the final [Q, k] ids and scores.
"""

from __future__ import annotations

import functools
from typing import Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from videoquery.core.meshes import DATA_AXIS
from videoquery.index.store import FeatureIndex


def _local_query(feats, mask, targets, tmask, weights, *, k):
    """Per-shard fused similarity + score + top-k.

    feats  : f?[S, K, n, D] local shard      targets: f32[Q, S, K, D]
    mask   : bool[S, K, n]                   tmask  : bool[Q, S, K]
    weights: f32[Q, S]
    Returns (vals f32[Q, k], local_idx i32[Q, k]).
    """
    sims = jnp.einsum(
        "sknd,qskd->qskn", feats, targets.astype(feats.dtype),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,  # keep f32 products exact, like
    )                                         # scoring.ensemble_similarities
    m = mask[None] & tmask[:, :, :, None]                   # [Q, S, K, n]
    counts = jnp.sum(m, axis=2)                             # [Q, S, n]
    total = jnp.sum(jnp.where(m, sims, 0.0), axis=2)
    avg = total / jnp.maximum(counts, 1)
    valid = jnp.all(counts > 0, axis=1)                     # [Q, n]
    dev = weights[:, :, None] * (1.0 - avg)                 # [Q, S, n]
    num = jnp.sum(dev * dev, axis=1)
    den = jnp.sum(weights * weights, axis=1)[:, None]
    scores = 1.0 - jnp.sqrt(num / den)
    scores = jnp.where(valid, scores, -jnp.inf)
    return jax.lax.top_k(scores, k)


def _sharded_query(feats, mask, targets, tmask, weights, *, k):
    n_local = feats.shape[2]
    vals, idx = _local_query(feats, mask, targets, tmask, weights, k=k)
    shard = jax.lax.axis_index(DATA_AXIS)
    gidx = idx + shard * n_local
    # Only [Q, k] crosses the wire per shard — never the [Q, N] scores.
    all_vals = jax.lax.all_gather(vals, DATA_AXIS)          # [ndev, Q, k]
    all_idx = jax.lax.all_gather(gidx, DATA_AXIS)
    ndev = all_vals.shape[0]
    q = all_vals.shape[1]
    flat_vals = all_vals.transpose(1, 0, 2).reshape(q, ndev * k)
    flat_idx = all_idx.transpose(1, 0, 2).reshape(q, ndev * k)
    top_vals, sel = jax.lax.top_k(flat_vals, k)
    top_idx = jnp.take_along_axis(flat_idx, sel, axis=1)
    return top_vals, top_idx


class ShardedSearch:
    """Batched multi-query top-k over a sharded FeatureIndex."""

    def __init__(self, index: FeatureIndex, mesh: Mesh):
        self.mesh = mesh
        n_shards = mesh.shape[DATA_AXIS]
        if index.n_padded % n_shards != 0:
            raise ValueError(
                f"padded clip axis {index.n_padded} not divisible by "
                f"{n_shards} data shards; build the index with "
                f"pad_multiple={n_shards} (or a multiple)"
            )
        sharding = NamedSharding(mesh, P(None, None, DATA_AXIS, None))
        self.index = index.shard(sharding)
        self._fns: dict[int, callable] = {}

    def _fn(self, k: int):
        """One compiled SPMD program per top-k size."""
        if k not in self._fns:
            self._fns[k] = jax.jit(
                jax.shard_map(
                    functools.partial(_sharded_query, k=k),
                    mesh=self.mesh,
                    in_specs=(
                        P(None, None, DATA_AXIS, None),  # feats
                        P(None, None, DATA_AXIS),        # mask
                        P(), P(), P(),                   # targets, tmask, weights
                    ),
                    out_specs=(P(), P()),
                    # the final top-k after all_gather is computed identically
                    # on every device (replicated), but the static
                    # varying-axes checker can't prove it — axis_index makes
                    # intermediate values device-varying
                    check_vma=False,
                )
            )
        return self._fns[k]

    def pack_targets(
        self,
        targets: Sequence[Mapping[str, Mapping[int, Sequence[float]]]],
        weights: Sequence[Mapping[str, float]],
    ):
        """[{stream: {split: vec}}] -> (targets, tmask, weights) arrays."""
        q = len(targets)
        idx = self.index
        t = np.zeros((q, len(idx.streams), len(idx.splits), idx.feature_dim),
                     np.float32)
        m = np.zeros((q, len(idx.streams), len(idx.splits)), bool)
        w = np.zeros((q, len(idx.streams)), np.float32)
        for qi, (target, wt) in enumerate(zip(targets, weights)):
            # host-side packing: target_arrays would upload per query only
            # for the arrays to be packed here again
            ta, ma = idx.target_arrays_host(target)
            t[qi], m[qi] = ta.astype(np.float32), ma
            w[qi] = [wt[s] for s in idx.streams]
        from videoquery.core.transfer import device_put_tree

        # replicated over the search mesh (works multi-process: put_global)
        return device_put_tree(
            (t, m, w), NamedSharding(self.mesh, P()))  # f32 + bool: 2 puts

    def topk(self, targets, tmask, weights, k: int = 20):
        """Device arrays in, (scores f32[Q, k], clip_ids i64[Q, k]) out."""
        vals, pos = self._fn(k)(self.index.feats, self.index.mask,
                                targets, tmask, weights)
        vals = np.asarray(vals)
        pos = np.asarray(pos)
        ids = np.where(
            pos < self.index.n_clips,
            np.asarray(self.index.clip_ids)[np.minimum(pos, self.index.n_clips - 1)],
            -1,
        )
        return vals, ids

    def query_dicts(self, target_dicts, weight_dicts, k: int = 20):
        t, m, w = self.pack_targets(target_dicts, weight_dicts)
        return self.topk(t, m, w, k)
