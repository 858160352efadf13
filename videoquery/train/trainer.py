"""TSN fine-tuning: segment-consensus training for BN-Inception streams.

The reference delegates training to the upstream TSN project (its GPU image
compiles MPI-enabled Caffe for multi-GPU training, reference
src/features_GPU_compute/Dockerfile:37-53, unused by the repo's own
scripts — SURVEY.md §2.3). This module provides the JAX equivalent so
new stream models (e.g. new datasets/splits) can be produced inside the
framework: temporal-segment consensus (average the segment logits, then
cross-entropy — the TSN recipe), SGD with momentum, dropout before
fc-action, frozen-BN semantics (BN is folded into convs and trains as part
of them).

Parallelism: pure SPMD data parallelism over the "data" mesh axis — the
batch is sharded, parameters are replicated, and XLA inserts the gradient
all-reduce from the shardings (jax.sharding + jit; no hand-written
collectives needed at BN-Inception scale).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import optax

from videoquery.core.meshes import DATA_AXIS
from videoquery.nn import bn_inception


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_segments: int = 3          # TSN temporal segments per video
    learning_rate: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 5e-4
    dropout_rate: float = 0.8      # deploy prototxt :742
    num_classes: int = bn_inception.NUM_CLASSES


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    return optax.chain(
        optax.add_decayed_weights(cfg.weight_decay),
        optax.sgd(cfg.learning_rate, momentum=cfg.momentum),
    )


def segment_consensus_loss(
    params: Any,
    frames: jax.Array,   # [B, S, H, W, C] preprocessed segment snippets
    labels: jax.Array,   # i32 [B]
    dropout_rng: jax.Array,
    cfg: TrainConfig,
) -> tuple[jax.Array, jax.Array]:
    """TSN loss: average logits over the S segments, then cross-entropy.
    Returns (loss, accuracy)."""
    b, s = frames.shape[:2]
    flat = frames.reshape((b * s,) + frames.shape[2:])
    out = bn_inception.apply(
        params, flat, dropout_rng=dropout_rng, dropout_rate=cfg.dropout_rate
    )
    logits = out["fc-action"].reshape(b, s, -1).mean(axis=1)  # consensus
    loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    acc = (logits.argmax(-1) == labels).mean()
    return loss, acc


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("params", "opt_state"))
def train_step(
    params: Any,
    opt_state: Any,
    frames: jax.Array,
    labels: jax.Array,
    rng: jax.Array,
    cfg: TrainConfig = TrainConfig(),
):
    """One SGD step. Under a Mesh with `frames`/`labels` sharded on the
    "data" axis and params replicated, XLA emits the psum for the gradient
    all-reduce automatically."""
    (loss, acc), grads = jax.value_and_grad(
        lambda p: segment_consensus_loss(p, frames, labels, rng, cfg),
        has_aux=True,
    )(params)
    tx = make_optimizer(cfg)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, {"loss": loss, "accuracy": acc}


class TSNTrainer:
    """Stateful convenience wrapper around train_step for one stream."""

    def __init__(self, params: Any, cfg: TrainConfig | None = None,
                 mesh=None):
        self.cfg = cfg or TrainConfig()
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from videoquery.core.transfer import put_global

            # put_global: replicating over a multi-process mesh needs every
            # process to supply its local shards (core/transfer.py)
            params = jax.tree.map(
                lambda p: put_global(p, NamedSharding(mesh, P())), params)
        self.params = params
        self.opt_state = jax.jit(make_optimizer(self.cfg).init)(self.params)

    def data_sharding(self, ndim: int):
        from jax.sharding import NamedSharding, PartitionSpec as P

        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, P(DATA_AXIS, *([None] * (ndim - 1))))

    def step(self, frames, labels, rng):
        if self.mesh is not None:
            from videoquery.core.transfer import put_global

            frames = put_global(frames, self.data_sharding(frames.ndim))
            labels = put_global(labels, self.data_sharding(1))
        self.params, self.opt_state, metrics = train_step(
            self.params, self.opt_state, frames, labels, rng, self.cfg
        )
        return metrics
