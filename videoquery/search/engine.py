"""SearchEngine: the device-side query round.

Glues the FeatureIndex to the scoring/optimizer math. One query round on the
reference is thousands of Python-level np.dot calls plus a 1200-evaluation
grid loop (ticket.py:120-180, hyperparameter.py:52-76); here it is two jitted
XLA programs (similarity einsum; loss-grid) regardless of search-set size,
sharded over the "data" mesh axis when the index is.

Two round flavors:

- SimilarityTable (compute_similarities): downloads the whole [S+1, N]
  similarity table once and finishes the round host-side in float64 — the
  default for broker-scale search sets.
- ResidentTable (compute_similarities_resident): the big-corpus path. The
  table never leaves the device wholesale; the optimizer gathers only the
  reviewed rows and selection downloads only the BANDED candidates
  (matches + near-misses + kept clips), so a 1M-segment revise round moves
  kilobytes instead of the 12 MB table. Selection results are IDENTICAL to
  the full path: the device band is widened by a margin exceeding any
  f32-vs-f64 score discrepancy and select_clips_to_review re-applies the
  exact float64 band itself.
"""

from __future__ import annotations

import functools
from typing import Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from videoquery.core.config import HyperParams, compute_eps
from videoquery.index.store import FeatureIndex
from videoquery.search.optimizer import GridResult, optimize_weights
from videoquery.search.scoring import (ensemble_similarities_batched,
                                       scores_from_similarities)


_PACK_F32_JIT = None

# Ensemble counts are tiny (<= n_splits, i.e. <= 3 for the reference's
# UCF101 ensemble), so all streams' counts pack losslessly into ONE f32 row
# of base-8 digits — the similarity download shrinks from [2S, N] to
# [S+1, N] (25% less to download at S=2; 4 MB/round at 1M segments).
_COUNT_RADIX = 8


def _pack_f32(avg, counts):
    """Stack (avg f32[S,N], counts i32[S,N]) into one f32[S+1,N] so the
    round's result leaves the device in a single transfer. Row S holds the
    per-stream counts as base-8 digits (exact: S*3 bits << f32's 24-bit
    integer range).

    The jitted pack is created once at first use (module-level cache):
    jit caches by callable identity, so a per-call lambda would re-trace
    every round."""
    global _PACK_F32_JIT
    if _PACK_F32_JIT is None:
        import jax
        import jax.numpy as jnp

        def pack(a, c):
            s = c.shape[0]
            scale = _COUNT_RADIX ** jnp.arange(s, dtype=jnp.int32)
            digits = jnp.sum(c * scale[:, None], axis=0).astype(jnp.float32)
            return jnp.concatenate([a, digits[None]], axis=0)

        _PACK_F32_JIT = jax.jit(pack)
    return _PACK_F32_JIT(avg, counts)


@jax.jit
def _pack_f32_batched(avg, counts):
    """Q-batched _pack_f32: (avg f32[Q,S,N], counts i32[Q,S,N]) ->
    f32[Q,S+1,N] with the counts row digit-packed per query."""
    s = counts.shape[1]
    scale = _COUNT_RADIX ** jnp.arange(s, dtype=jnp.int32)
    digits = jnp.sum(counts * scale[None, :, None], axis=1)
    return jnp.concatenate([avg, digits.astype(jnp.float32)[:, None]], axis=1)


def _unpack_counts(digits: np.ndarray, s: int) -> np.ndarray:
    """Invert _pack_f32's count row: f32[N] -> i32[S, N]."""
    d = np.rint(digits).astype(np.int64)
    return np.stack(
        [(d // _COUNT_RADIX ** si) % _COUNT_RADIX for si in range(s)]
    ).astype(np.int32)


# Device-band widening for the big-corpus candidate download. The device
# evaluates scores and the near-miss bound in f32 while selection re-applies
# them in f64; both discrepancies are bounded by a few f32 ulps of values
# <= 1 (~1e-6 after the finalize bound's arithmetic), so a 1e-5 margin
# guarantees the downloaded candidate set is a superset of the exact band.
_BAND_MARGIN = 1e-5


@jax.jit
def _gather_sim_rows(avg, pos):
    """avg f32[S, N], pos i32[M] -> f32[S, M] (reviewed-clip similarities)."""
    return jnp.take(avg, pos, axis=1)


@jax.jit
def _gather_sim_rows_many(avg_q, sel, pos_q):
    """Batched reviewed-row gather: avg_q f32[Qb, S, N], sel i32[Q] (parent
    rows), pos_q i32[Q, M] -> f32[Q, S, M] — ONE program + one download for
    a whole poll group instead of one per query."""
    return jax.vmap(
        lambda s, p: jnp.take(jnp.take(avg_q, s, axis=0), p, axis=1)
    )(sel, pos_q)


def _banded_core(avg, counts, weights, threshold, near_miss, eps,
                 keep_pos, um_pos, um_mask, cap: int, finalize: bool):
    """One packed f32 vector holding everything selection needs.

    Layout (raveled): candidates [S+2, cap] (avg rows, valid bit, position
    as exact-in-f32 integer), kept clips [S+1, KP] (avg rows, valid bit),
    then [n_in_band]. finalize=True derives the near-miss bound from the
    lowest-scoring user match on device (reference compute_matches.py:78-85
    arithmetic, f32; the margin absorbs the f64 difference).

    Shared verbatim by the single-query jit and the Q-vmapped group program
    (_banded_candidates_many): every op is elementwise or a fixed-order
    tiny reduction, so the batched rows are bit-identical to solo runs."""
    valid = jnp.all(counts > 0, axis=0)                       # [N]
    scores = jnp.where(valid, scores_from_similarities(avg, weights),
                       -jnp.inf)
    if finalize:
        um_scores = jnp.where(um_mask & jnp.take(valid, um_pos),
                              jnp.take(scores, um_pos), jnp.inf)
        low = jnp.minimum(1.0, jnp.min(um_scores, initial=jnp.inf))
        nm = jnp.maximum(threshold - low, 0.0) / jnp.maximum(
            1.0 - threshold, eps)
    else:
        nm = near_miss
    lower = threshold - nm * (1.0 - threshold)
    in_band = scores >= lower - _BAND_MARGIN
    n_cand = jnp.sum(in_band)
    idx = jnp.nonzero(in_band, size=cap, fill_value=-1)[0]    # ascending
    safe = jnp.maximum(idx, 0)
    cand = jnp.concatenate([
        jnp.take(avg, safe, axis=1),
        (jnp.take(valid, safe) & (idx >= 0))[None].astype(jnp.float32),
        idx.astype(jnp.float32)[None],  # exact: cap < 2^24
    ])
    keep = jnp.concatenate([
        jnp.take(avg, keep_pos, axis=1),
        jnp.take(valid, keep_pos)[None].astype(jnp.float32),
    ])
    return jnp.concatenate([
        cand.ravel(), keep.ravel(),
        n_cand.astype(jnp.float32)[None],
    ])


_banded_candidates = functools.partial(
    jax.jit, static_argnames=("cap", "finalize"))(_banded_core)


@functools.partial(jax.jit, static_argnames=("cap", "finalize"))
def _banded_candidates_many(avg_q, counts_q, weights, threshold, near_miss,
                            eps, keep_pos, um_pos, um_mask, cap: int,
                            finalize: bool):
    """Q-batched _banded_core: one program + ONE download for every query
    of a poll group (avg_q f32[Q,S,N]; all other args carry a leading Q)."""
    return jax.vmap(
        lambda a, c, w, t, n, kp, up, um: _banded_core(
            a, c, w, t, n, eps, kp, up, um, cap, finalize)
    )(avg_q, counts_q, weights, threshold, near_miss,
      keep_pos, um_pos, um_mask)


def _scores_f64(avg: np.ndarray, w: np.ndarray) -> np.ndarray:
    """float64 weighted score of f32 similarity rows — the same bits
    SimilarityTable.scores produces (ticket.py:165-180)."""
    dev = w[:, None] * (1.0 - avg.astype(np.float64))
    return 1.0 - np.sqrt((dev * dev).sum(axis=0) / (w * w).sum())


def _pad_positions(pos: list[int], multiple: int = 8, at_least: int = 0
                   ) -> tuple[np.ndarray, int]:
    """Pad a position list to a bucket size (position 0 as filler) so every
    distinct keep/reviewed count does not compile a fresh program.
    at_least forces a common bucket across a query group."""
    m = len(pos)
    mp = max(multiple, at_least, -(-m // multiple) * multiple)
    out = np.zeros(mp, np.int32)
    out[:m] = pos
    return out, m


def _pad_q(q: int) -> int:
    """Query-count bucket: power of two, >= 2 (the gemm bit-compatibility
    floor, see ensemble_similarities_batched)."""
    qb = 2
    while qb < q:
        qb *= 2
    return qb


class SimilarityTable:
    """Host-side view of the device similarity computation for one target."""

    def __init__(self, index: FeatureIndex, avg_sim: np.ndarray, counts: np.ndarray):
        self.index = index
        self.avg_sim = avg_sim  # f32[S, Npad]
        self.counts = counts    # i32[S, Npad]

    def valid_positions(self) -> np.ndarray:
        n = self.index.n_clips
        return np.flatnonzero((self.counts[:, :n] > 0).all(axis=0))

    def similarities_dict(self) -> dict[int, dict[str, list]]:
        """The reference's similarity structure
        {clip: {stream: [avg_sim, n_ensemble]}} (ticket.py:124), in canonical
        ascending-clip-id order, for API/report compatibility."""
        out: dict[int, dict[str, list]] = {}
        n = self.index.n_clips
        for pos in range(n):
            entry = {}
            for si, stream in enumerate(self.index.streams):
                c = int(self.counts[si, pos])
                if c > 0:
                    entry[stream] = [float(self.avg_sim[si, pos]), c]
            if entry:
                out[int(self.index.clip_ids[pos])] = entry
        return out

    def scores(self, weights: Mapping[str, float]) -> dict[int, float]:
        """{clip_id: score} for every clip with all streams present, ascending
        clip id (ticket.py:165-180 + the determinism contract).

        The elementwise score is computed host-side in float64 (the
        similarities are already materialized here); the device-fused
        score path for huge corpora lives in scoring.weighted_scores."""
        n = self.index.n_clips
        w = np.asarray([weights[s] for s in self.index.streams], np.float64)
        avg = self.avg_sim[:, :n].astype(np.float64)
        valid = (self.counts[:, :n] > 0).all(axis=0)
        dev = w[:, None] * (1.0 - avg)
        sc = 1.0 - np.sqrt((dev * dev).sum(axis=0) / (w * w).sum())
        # dict(zip(...tolist())) builds the same ascending-clip-id dict ~6x
        # faster than a per-element Python loop (measured 96 -> 15 ms at
        # 100k clips — it was a visible slice of the revise round)
        ids = np.asarray(self.index.clip_ids[:n])[valid]
        return dict(zip(ids.tolist(), sc[valid].tolist()))

    def optimize(
        self, reviewed_labels: Mapping[int, float], hp: HyperParams
    ) -> tuple[HyperParams, GridResult]:
        """Grid + parabolic optimization over the reviewed clips
        (hyperparameter.py:29-76). reviewed_labels: {clip_id: 0/1}.

        Returns hyperparams updated with the new round state."""
        positions, labels = [], []
        for clip_id, label in reviewed_labels.items():
            pos = self.index.position(clip_id)
            if pos is None:
                raise KeyError(f"reviewed clip {clip_id} not in the search set")
            positions.append(pos)
            labels.append(float(label))
        sim = self.avg_sim[:, np.asarray(positions, np.int64)]
        result = optimize_weights(
            sim,
            np.asarray(labels, np.float64),
            hp.weight_grid,
            hp.threshold_grid,
            hp.ballast,
            compute_eps(),
            exact=sim.dtype == np.float64,
        )
        new_weights = {hp.streams[0]: 1.0, hp.streams[1]: result.weight}
        return hp.with_round_state(new_weights, result.threshold), result


class ResidentTable:
    """Device-resident similarity table: the big-corpus round.

    avg/counts stay on device. optimize() downloads only the reviewed rows
    ([S, M] for M reviewed clips); round_scores() downloads only the banded
    candidates plus kept clips, returning the reduced ascending-clip-id
    scores dict that select_clips_to_review needs — its exact float64 band
    filtering makes the selection bit-identical to the full-download path
    (the device band is margin-widened, see _BAND_MARGIN)."""

    def __init__(self, index: FeatureIndex, avg, counts, batch=None):
        self.index = index
        self.avg = avg        # f32[S, Npad] device
        self.counts = counts  # i32[S, Npad] device
        # (avg_q f32[Qb,S,Npad], counts_q, qi): set when this table is one
        # row of a batched poll group (compute_similarities_multi) — lets
        # optimize_many / round_scores_many run the whole group's downloads
        # as single programs
        self.batch = batch

    def _positions(self, clip_ids: Sequence[int]) -> list[int]:
        out = []
        for cid in clip_ids:
            pos = self.index.position(cid)
            if pos is not None:
                out.append(pos)
        return out

    def optimize(
        self, reviewed_labels: Mapping[int, float], hp: HyperParams
    ) -> tuple[HyperParams, GridResult]:
        """SimilarityTable.optimize semantics; the reviewed similarities are
        gathered on device and downloaded alone (kilobytes, not the table)."""
        positions, labels = [], []
        for clip_id, label in reviewed_labels.items():
            pos = self.index.position(clip_id)
            if pos is None:
                raise KeyError(f"reviewed clip {clip_id} not in the search set")
            positions.append(pos)
            labels.append(float(label))
        pos_p, m = _pad_positions(positions)
        sim = np.asarray(_gather_sim_rows(self.avg, jnp.asarray(pos_p)))[:, :m]
        result = optimize_weights(
            sim, np.asarray(labels, np.float64),
            hp.weight_grid, hp.threshold_grid, hp.ballast, compute_eps(),
        )
        new_weights = {hp.streams[0]: 1.0, hp.streams[1]: result.weight}
        return hp.with_round_state(new_weights, result.threshold), result

    def round_scores(
        self,
        weights: Mapping[str, float],
        threshold: float,
        near_miss: float,
        keep_ids: Sequence[int] = (),
        user_match_ids: Sequence[int] = (),
        finalize: bool = False,
        caps: Sequence[int] = (32_768, 262_144),
    ) -> dict[int, float] | None:
        """Reduced {clip_id: score} covering the selection band and the kept
        clips, in canonical ascending-clip-id order with the same float64
        score bits as SimilarityTable.scores.

        The candidate download is cap-sized, so caps escalate: the common
        case pays a ~0.5 MB transfer, a wide band retries at the next cap,
        and a band wider than every cap returns None — the caller then
        falls back to the full-table download."""
        for cap in caps:
            out = self._round_scores_once(weights, threshold, near_miss,
                                          keep_ids, user_match_ids,
                                          finalize, cap)
            if out is not None:
                return out
        return None

    def _banded_args(self, weights, keep_ids, user_match_ids,
                     keep_bucket: int = 0, um_bucket: int = 0):
        """Host-side argument prep shared by the solo and group programs.
        The bucket floors let a poll group share one padded shape."""
        w = np.asarray([weights[st] for st in self.index.streams], np.float64)
        keep_pos, n_keep = _pad_positions(self._positions(keep_ids),
                                          at_least=keep_bucket)
        um_pos, n_um = _pad_positions(self._positions(user_match_ids),
                                      at_least=um_bucket)
        um_mask = np.zeros(um_pos.shape[0], bool)
        um_mask[:n_um] = True
        return w, keep_pos, n_keep, um_pos, um_mask

    def _unpack_banded(self, packed: np.ndarray, w: np.ndarray,
                       keep_pos: np.ndarray, n_keep: int, cap: int
                       ) -> dict[int, float] | None:
        """Turn one packed download (see _banded_core) into the reduced
        ascending-clip-id float64 scores dict, or None on band overflow."""
        s = len(self.index.streams)
        cand_sz = (s + 2) * cap
        keep_sz = (s + 1) * keep_pos.shape[0]
        cand = packed[:cand_sz].reshape(s + 2, cap)
        keep = packed[cand_sz:cand_sz + keep_sz].reshape(s + 1, -1)
        n_cand = int(round(packed[-1]))
        if n_cand > cap:
            return None
        pos_score: dict[int, float] = {}
        cvalid = cand[s] > 0.5
        cpos = np.rint(cand[s + 1]).astype(np.int64)
        cscores = _scores_f64(cand[:s].astype(np.float32), w)
        for p, sc in zip(cpos[cvalid].tolist(), cscores[cvalid].tolist()):
            pos_score[p] = sc
        kvalid = keep[s, :n_keep] > 0.5
        kscores = _scores_f64(keep[:s, :n_keep].astype(np.float32), w)
        for p, ok, sc in zip(keep_pos[:n_keep].tolist(), kvalid.tolist(),
                             kscores.tolist()):
            if ok:
                pos_score[p] = sc
        ids = np.asarray(self.index.clip_ids)
        return {int(ids[p]): pos_score[p] for p in sorted(pos_score)}

    def _round_scores_once(self, weights, threshold, near_miss, keep_ids,
                           user_match_ids, finalize: bool, cap: int
                           ) -> dict[int, float] | None:
        w, keep_pos, n_keep, um_pos, um_mask = self._banded_args(
            weights, keep_ids, user_match_ids)
        packed = np.asarray(_banded_candidates(
            self.avg, self.counts, jnp.asarray(w, jnp.float32),
            jnp.float32(threshold), jnp.float32(near_miss),
            jnp.float32(compute_eps()), jnp.asarray(keep_pos),
            jnp.asarray(um_pos), jnp.asarray(um_mask),
            cap=cap, finalize=finalize,
        ), np.float64)
        return self._unpack_banded(packed, w, keep_pos, n_keep, cap)

    def to_table(self) -> SimilarityTable:
        """Full-download fallback (identical to compute_similarities)."""
        return _download_table(self.index, self.avg, self.counts)


def _shared_batch(tables: Sequence[ResidentTable]):
    """The common batch parent of a poll group's tables, or None."""
    if not tables or tables[0].batch is None:
        return None
    parent = tables[0].batch[0]
    for t in tables:
        if t.batch is None or t.batch[0] is not parent:
            return None
    return tables[0].batch[:2]


def optimize_many(
    tables: Sequence[ResidentTable],
    labels_list: Sequence[Mapping[int, float]],
    hp: HyperParams,
) -> list[tuple[HyperParams, GridResult]]:
    """Batched ResidentTable.optimize across one poll group: every query's
    reviewed rows are gathered by ONE device program and downloaded in ONE
    transfer (solo, each query pays its own gather and download). The
    per-query grid/parabolic optimization stays host-side float64 —
    bit-identical to solo optimize (the gather moves bits, it computes
    nothing)."""
    if not tables:
        return []
    shared = _shared_batch(tables)
    if shared is None or len(tables) == 1:
        return [t.optimize(labels, hp)
                for t, labels in zip(tables, labels_list)]
    avg_q, _ = shared
    per: list[tuple[list[int], list[float]]] = []
    for table, labels in zip(tables, labels_list):
        positions, lab = [], []
        for clip_id, label in labels.items():
            pos = table.index.position(clip_id)
            if pos is None:
                raise KeyError(
                    f"reviewed clip {clip_id} not in the search set")
            positions.append(pos)
            lab.append(float(label))
        per.append((positions, lab))
    m_bucket = max(_pad_positions(p)[0].shape[0] for p, _ in per)
    q = len(tables)
    qb = _pad_q(q)
    pos_q = np.zeros((qb, m_bucket), np.int32)
    sel = np.zeros(qb, np.int32)
    for qi, (table, (positions, _)) in enumerate(zip(tables, per)):
        pos_q[qi], _ = _pad_positions(positions, at_least=m_bucket)
        sel[qi] = table.batch[2]
    sims = np.asarray(_gather_sim_rows_many(
        avg_q, jnp.asarray(sel), jnp.asarray(pos_q)))
    out = []
    for qi, (table, (positions, lab)) in enumerate(zip(tables, per)):
        sim = sims[qi][:, :len(positions)]
        result = optimize_weights(
            sim, np.asarray(lab, np.float64),
            hp.weight_grid, hp.threshold_grid, hp.ballast, compute_eps(),
        )
        new_weights = {hp.streams[0]: 1.0, hp.streams[1]: result.weight}
        out.append((hp.with_round_state(new_weights, result.threshold),
                    result))
    return out


def round_scores_many(
    tables: Sequence[ResidentTable],
    rounds: Sequence[Mapping],
    caps: Sequence[int] = (32_768, 262_144),
) -> list[dict[int, float] | None]:
    """Batched ResidentTable.round_scores across one poll group: the banded
    candidates of every query come back in ONE download per finalize-flavor
    (the band program is vmapped over Q; _banded_core is shared verbatim
    with the solo path, so each row is bit-identical to a solo round).

    rounds[i]: {weights, threshold, near_miss, keep_ids, user_match_ids,
    finalize}. A query whose band overflows the group cap retries solo at
    the escalated caps; None means wider than every cap (caller falls back
    to the full-table download), exactly like solo round_scores."""
    results: list = [None] * len(tables)
    shared = _shared_batch(tables)
    if shared is None or len(tables) == 1:
        return [
            t.round_scores(r["weights"], r["threshold"], r["near_miss"],
                           r["keep_ids"], r["user_match_ids"],
                           finalize=r["finalize"], caps=caps)
            for t, r in zip(tables, rounds)
        ]
    avg_q, counts_q = shared
    eps = compute_eps()
    by_flavor: dict[bool, list[int]] = {}
    for i, r in enumerate(rounds):
        by_flavor.setdefault(bool(r["finalize"]), []).append(i)
    for finalize, idxs in by_flavor.items():
        args = [tables[i]._banded_args(
            rounds[i]["weights"], rounds[i]["keep_ids"],
            rounds[i]["user_match_ids"]) for i in idxs]
        keep_bucket = max(a[1].shape[0] for a in args)
        um_bucket = max(a[3].shape[0] for a in args)
        args = [tables[i]._banded_args(
            rounds[i]["weights"], rounds[i]["keep_ids"],
            rounds[i]["user_match_ids"], keep_bucket, um_bucket)
            for i in idxs]
        q = len(idxs)
        qb = _pad_q(q)
        s = len(tables[0].index.streams)
        sel = np.zeros(qb, np.int32)
        w_q = np.zeros((qb, s), np.float32)
        th_q = np.zeros(qb, np.float32)
        nm_q = np.zeros(qb, np.float32)
        keep_q = np.zeros((qb, keep_bucket), np.int32)
        um_q = np.zeros((qb, um_bucket), np.int32)
        umm_q = np.zeros((qb, um_bucket), bool)
        for row, (i, (w, keep_pos, _nk, um_pos, um_mask)) in enumerate(
                zip(idxs, args)):
            sel[row] = tables[i].batch[2]
            w_q[row] = w
            th_q[row] = rounds[i]["threshold"]
            nm_q[row] = rounds[i]["near_miss"]
            keep_q[row] = keep_pos
            um_q[row] = um_pos
            umm_q[row] = um_mask
        packed = np.asarray(_banded_candidates_many(
            jnp.take(avg_q, jnp.asarray(sel), axis=0),
            jnp.take(counts_q, jnp.asarray(sel), axis=0),
            jnp.asarray(w_q), jnp.asarray(th_q), jnp.asarray(nm_q),
            jnp.float32(eps), jnp.asarray(keep_q), jnp.asarray(um_q),
            jnp.asarray(umm_q), cap=caps[0], finalize=finalize,
        ), np.float64)
        for row, (i, (w, keep_pos, n_keep, _up, _um)) in enumerate(
                zip(idxs, args)):
            out = tables[i]._unpack_banded(packed[row], w, keep_pos, n_keep,
                                           caps[0])
            if out is None and len(caps) > 1:  # overflow: solo escalation
                r = rounds[i]
                out = tables[i].round_scores(
                    r["weights"], r["threshold"], r["near_miss"],
                    r["keep_ids"], r["user_match_ids"],
                    finalize=r["finalize"], caps=caps[1:])
            results[i] = out
    return results


def _download_table(index: FeatureIndex, avg, counts) -> SimilarityTable:
    """ONE download: counts are tiny ints (<= n_splits), packed exactly
    into one extra f32 row instead of a second device->host transfer."""
    s = avg.shape[0]
    if len(index.splits) < _COUNT_RADIX and 3 * s <= 24:
        packed = np.asarray(_pack_f32(avg, counts))
        return SimilarityTable(index, packed[:s], _unpack_counts(packed[s], s))
    # ensembles too wide for digit packing (never the reference shape)
    return SimilarityTable(index, np.asarray(avg), np.asarray(counts))


class SearchEngine:
    """Two numerics modes:

    - default: float32 on device with HIGHEST matmul precision (no TF32) —
      the performance path.
    - exact=True: float64 on host BLAS — bit-comparable to the reference's
      numpy math for parity validation and small corpora. Requires the index
      to have been built with keep_host=True.
    """

    def __init__(self, index: FeatureIndex, exact: bool = False):
        self.index = index
        self.exact = exact
        if exact and index.host_feats is None:
            raise ValueError("exact mode needs FeatureIndex.build(keep_host=True)")

    def compute_similarities(
        self, target: Mapping[str, Mapping[int, list]]
    ) -> SimilarityTable:
        if self.exact:
            return self._compute_similarities_host(target)
        return self.compute_similarities_multi([target])[0]

    def compute_similarities_resident(
        self, target: Mapping[str, Mapping[int, list]]
    ) -> ResidentTable:
        """Big-corpus flavor: the similarity table stays on device (see
        ResidentTable). Device path only — exact mode keeps its float64
        host table."""
        if self.exact:
            raise ValueError("the resident table is the f32 device path; "
                             "exact mode downloads the full float64 table")
        return self.compute_similarities_multi([target], resident=True)[0]

    def compute_similarities_multi(
        self,
        targets: Sequence[Mapping[str, Mapping[int, list]]],
        resident: bool = False,
    ) -> list:
        """Q concurrent query targets against the shared index in ONE device
        program (scoring.ensemble_similarities_batched) — the batched serving
        path replacing the reference's one-job-per-5 s-poll shape
        (api_repository.py:53-63, broker.py:87).

        Returns one SimilarityTable (or ResidentTable, resident=True) per
        target, in order. Q is padded up to a power-of-two bucket of at
        least 2 — the >= 2 floor is the bit-compatibility contract (a lone
        query lowered as a gemv accumulates in a different order than a gemm
        column), so a query processed alone and the same query processed in
        a batch produce IDENTICAL similarity bits; buckets bound compile
        count."""
        if self.exact:
            raise ValueError("exact mode scores targets host-side one at a "
                             "time (SearchEngine.compute_similarities)")
        q = len(targets)
        if q == 0:
            return []
        idx = self.index
        s, k, d = len(idx.streams), len(idx.splits), idx.feature_dim
        qb = _pad_q(q)
        t = np.zeros((qb, s, k, d), np.float32)
        m = np.zeros((qb, s, k), bool)
        for qi, target in enumerate(targets):
            ta, ma = idx.target_arrays_host(target)
            t[qi], m[qi] = ta.astype(np.float32), ma
        avg, counts = ensemble_similarities_batched(
            jnp.asarray(t), jnp.asarray(m), idx.feats, idx.mask
        )
        if resident:
            return [ResidentTable(idx, avg[qi], counts[qi],
                                  batch=(avg, counts, qi))
                    for qi in range(q)]
        # one download for the whole batch (the padded tail is never read),
        # counts digit-packed into an extra f32 row like _download_table
        if len(idx.splits) < _COUNT_RADIX and 3 * s <= 24:
            packed = np.asarray(_pack_f32_batched(avg, counts)[:q])
            return [SimilarityTable(idx, packed[qi, :s],
                                    _unpack_counts(packed[qi, s], s))
                    for qi in range(q)]
        avg_h = np.asarray(avg[:q])
        counts_h = np.asarray(counts[:q])
        return [SimilarityTable(idx, avg_h[qi], counts_h[qi])
                for qi in range(q)]

    def _compute_similarities_host(self, target) -> SimilarityTable:
        targets, tmask = self.index.target_arrays_host(target)
        feats, mask = self.index.host_feats, self.index.host_mask
        s, k, n, _ = feats.shape
        sims = np.empty((s, k, n), np.float64)
        for si in range(s):
            for ki in range(k):
                sims[si, ki] = feats[si, ki] @ targets[si, ki]
        m = mask & tmask[:, :, None]
        counts = m.sum(axis=1).astype(np.int32)
        avg = np.where(m, sims, 0.0).sum(axis=1) / np.maximum(counts, 1)
        return SimilarityTable(self.index, avg, counts)
