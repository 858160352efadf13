"""Ensemble similarity and scoring as batched array programs.

The reference computes, per job, a Python triple-loop of 1024-d dot products
over (stream, split, clip) followed by per-clip ensemble averaging
(reference ticket.py:120-163), then a per-clip weighted score
(ticket.py:165-180). Here the whole thing is two einsums + masked reductions
over dense arrays, so the entire search set is scored in one XLA program on
the accelerator's matrix units.

Array layout (the framework-wide convention):

    targets    : f32[S, K, D]      one target vector per (stream, split)
    target_mask: bool[S, K]        split present in the target?
    cands      : f32[S, K, N, D]   candidate features (the search-set index)
    cand_mask  : bool[S, K, N]     feature present for (stream, split, clip)?

S = number of streams (2: rgb, warped_optical_flow), K = splits (3),
N = clips in the search set, D = 1024.

Masking preserves the reference's variable-ensemble semantics: a clip that
misses a split is averaged over the splits it has (ticket.py:154-160), and a
clip missing a stream entirely is excluded from scoring (it would KeyError at
ticket.py:177 in the reference).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def ensemble_similarities(
    targets: jax.Array,      # f32[S, K, D]
    target_mask: jax.Array,  # bool[S, K]
    cands: jax.Array,        # f32[S, K, N, D]
    cand_mask: jax.Array,    # bool[S, K, N]
) -> tuple[jax.Array, jax.Array]:
    """Per-(stream, clip) ensemble-averaged dot-product similarity.

    Returns (avg_sim f32[S, N], counts int32[S, N]) — the batched equivalent
    of the reference's ``{clip: {stream: [avg_sim, n_ensemble]}}`` dict
    (ticket.py:124,154-160).
    """
    # One batched matvec per (stream, split): [S,K,N,D] x [S,K,D] -> [S,K,N].
    # HIGHEST precision keeps f32 products exact (no TF32 on the GPU).
    sims = jnp.einsum(
        "sknd,skd->skn", cands, targets,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    mask = cand_mask & target_mask[:, :, None]            # bool[S, K, N]
    counts = jnp.sum(mask, axis=1).astype(jnp.int32)      # [S, N]
    total = jnp.sum(jnp.where(mask, sims, 0.0), axis=1)   # [S, N]
    avg = total / jnp.maximum(counts, 1).astype(sims.dtype)
    return avg, counts


@jax.jit
def ensemble_similarities_batched(
    targets: jax.Array,      # f32[Q, S, K, D]  one target per concurrent query
    target_mask: jax.Array,  # bool[Q, S, K]
    cands: jax.Array,        # f32[S, K, N, D]  the SHARED search-set index
    cand_mask: jax.Array,    # bool[S, K, N]
) -> tuple[jax.Array, jax.Array]:
    """Q concurrent queries over one search set in a single device program.

    Returns (avg_sim f32[Q, S, N], counts int32[Q, S, N]). The contraction
    is one gemm per (stream, split) — [N, D] x [D, Q] — so the index is read
    from HBM ONCE for all Q queries; on the bandwidth-bound 1M-segment round
    that makes Q queries cost ~1 query (the reference processes one job per
    5 s poll, api_repository.py:53-63 + broker.py:87 — this is the batched
    serving path that replaces it).

    Bit-compatibility contract: for Q >= 2 the per-query output columns are
    bit-identical regardless of how many queries share the batch (the gemm
    accumulates over D in a Q-independent order; verified on the CPU
    backend, not yet on cuBLAS — ROADMAP D5). Q == 1 lowers to a gemv with a DIFFERENT reduction
    order — callers must pad Q to >= 2 (SearchEngine does) so sequential
    and batched serving produce identical bits.
    """
    sims = jnp.einsum(
        "sknd,qskd->qskn", cands, targets,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    mask = cand_mask[None] & target_mask[:, :, :, None]    # bool[Q, S, K, N]
    counts = jnp.sum(mask, axis=2).astype(jnp.int32)       # [Q, S, N]
    total = jnp.sum(jnp.where(mask, sims, 0.0), axis=2)    # [Q, S, N]
    avg = total / jnp.maximum(counts, 1).astype(sims.dtype)
    return avg, counts


def scores_from_similarities(avg_sim: jax.Array, weights: jax.Array) -> jax.Array:
    """Weighted ensemble score (reference ticket.py:165-180, Appendix B of
    SURVEY.md):

        score = 1 - sqrt( sum_s (w_s * (1 - sim_s))^2 / sum_s w_s^2 )

    avg_sim: f32[S, N] (or any [..., S, N] with weights [..., S]).
    weights: f32[S].
    Returns f32[N].
    """
    dev = weights[..., :, None] * (1.0 - avg_sim)
    num = jnp.sum(dev * dev, axis=-2)
    den = jnp.sum(weights * weights, axis=-1)[..., None]
    return 1.0 - jnp.sqrt(num / den)


@jax.jit
def weighted_scores(
    avg_sim: jax.Array,   # f32[S, N]
    counts: jax.Array,    # int32[S, N]
    weights: jax.Array,   # f32[S]
) -> tuple[jax.Array, jax.Array]:
    """Scores for every clip plus the validity mask.

    A clip is valid iff it has at least one ensemble member for *every*
    stream (the reference would KeyError otherwise; SURVEY.md §7 'hard
    parts'). Invalid clips get score -inf so they never select as matches.
    """
    valid = jnp.all(counts > 0, axis=0)  # bool[N]
    scores = scores_from_similarities(avg_sim, weights)
    return jnp.where(valid, scores, -jnp.inf), valid


@functools.partial(jax.jit, static_argnames=("pin_first_weight",))
def score_weight_grid(
    avg_sim_reviewed: jax.Array,  # f32[S, M] similarities of reviewed clips
    weight_grid: jax.Array,       # f32[W] grid over the *second* stream weight
    pin_first_weight: bool = True,
) -> jax.Array:
    """Scores of the reviewed clips for every grid weight: f32[W, M].

    Mirrors the reference pinning the rgb weight at 1.0 and sweeping the flow
    weight (hyperparameter.py:58,76). Only 2-stream search sweeps are
    supported, like the reference.
    """
    del pin_first_weight  # only True is implemented; kept for API clarity
    s = avg_sim_reviewed  # [2, M]
    w = weight_grid[:, None]  # [W, 1]
    num = (1.0 - s[0]) ** 2 + (w * (1.0 - s[1])) ** 2  # [W, M]
    den = 1.0 + w * w
    return 1.0 - jnp.sqrt(num / den)
