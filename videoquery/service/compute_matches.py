"""Match-computation orchestrator — the serving path of the framework.

Mirrors the reference control flow (compute_matches.py:8-114) with two
structural upgrades:

1. The math is the batched device engine: per job, one similarity program
   over the whole search set, the optimizer grid as one program, banded
   candidate downloads for big corpora.

2. The poll DRAINS every pending job and batches concurrent queries over
   the same search set into ONE device program. The reference processes at
   most one job per type per 5 s poll (api_repository.py:53-63,
   broker.py:87), so N pending queries cost N polls x 5 s and N full
   passes over the search set. Here the drain loop re-polls the same three
   endpoints until they run dry (each pickup's state-3 PATCH removes the
   job from the pending pool, so this needs NO API surface beyond the
   reference's), groups the jobs by search set, and scores Q concurrent
   targets against the shared index in one gemm-shaped program
   (SearchEngine.compute_similarities_multi) — the index is read from HBM
   once for all Q queries. Per-query optimizer / selection / persistence /
   report are unchanged, and results are BIT-IDENTICAL to processing the
   same jobs one per poll (tests/test_batch_serving.py asserts it).

Determinism: with a RANDOM_SEED, each job draws from its own PRNG seeded
by (seed, query_id, round, job type), so results are reproducible AND
independent of which jobs happen to share a poll. (The reference seeds one
global `random` per poll, broker.py:83-84, which makes outcomes depend on
job arrival interleaving; a shared-rng fallback is kept for callers that
pass `rng` without a seed.)
"""

from __future__ import annotations

import dataclasses
import logging
import random
from typing import Any, Mapping

from videoquery.core.config import (
    HyperParams,
    STATE_FINALIZED,
    STATE_IN_PROGRESS,
    STATE_PROCESSED,
    SearchConfig,
    compute_eps,
)
from videoquery.index.store import FeatureIndex
from videoquery.search.engine import ResidentTable, SearchEngine
from videoquery.search.selection import (
    INFINITE_MATCHES,
    finalize_near_miss,
    lowest_scoring_user_match,
    select_clips_to_review,
)
from videoquery.search.target import TargetEstimator
from videoquery.service import lease
from videoquery.service.repository import APIRepository
from videoquery.service.ticket import Ticket

log = logging.getLogger(__name__)


class SearchSetCache:
    """Device-resident index cache keyed by search-set id.

    The reference refetches and re-parses the ENTIRE search set's features
    from the API on every round of every query (ticket.py:358-382 — the
    dominant cost of a revise round at scale). Rounds of the same query (and
    different queries over the same search set) reuse the device index,
    keyed by the search set's version signal — an API that exposes no
    version-ish field gets reference semantics (refetch every round, the
    cache is bypassed in process_job) so a grown search set can never serve
    stale candidates. The TTL additionally bounds staleness for versioned
    sets whose signal might lag (e.g. a coarse updated_at)."""

    def __init__(self, ttl_seconds: float = 300.0, max_entries: int = 4):
        self.ttl = ttl_seconds
        self.max_entries = max_entries
        self._entries: dict[tuple, tuple[float, FeatureIndex]] = {}

    def get(self, key: tuple, build) -> FeatureIndex:
        import time

        now = time.monotonic()
        hit = self._entries.get(key)
        if hit is not None and now - hit[0] < self.ttl:
            return hit[1]
        index = build()
        if len(self._entries) >= self.max_entries:
            oldest = min(self._entries, key=lambda k: self._entries[k][0])
            del self._entries[oldest]
        self._entries[key] = (now, index)
        return index


@dataclasses.dataclass
class _Job:
    """One drained pending job, carried through the batched poll."""

    update_type: str
    update_object: Mapping[str, Any]
    ticket: Ticket
    rng: random.Random | None
    ref_splits: set | None = None
    table: Any = None  # SimilarityTable | ResidentTable, set by the group pass
    # group-batched round results (resident groups only): the optimizer
    # gathers and banded-candidate downloads of the whole group run as
    # single device programs (engine.optimize_many / round_scores_many)
    hp_round: Any = None
    scores: Any = None


def _job_rng(seed, rng, update_object, update_type) -> random.Random | None:
    """Per-job PRNG. With a seed: derived from (seed, query, round, type) so
    draws do not depend on which other jobs share the poll — the batching
    bit-identity contract. Without one: the caller's shared rng (draw order
    then depends on batch composition, like the reference's global seeding,
    broker.py:83-84)."""
    if seed is not None:
        lqr = update_object.get("latest_query_result")
        nround = 1 if update_type == "new" else (lqr["round"] + 1 if lqr else 1)
        return random.Random(
            f"{seed}|{update_object['query_id']}|{nround}|{update_type}")
    return rng


def drain_pending_jobs(
    query_updates: APIRepository,
    client,
    *,
    rng: random.Random | None = None,
    seed=None,
    report_dir: str = "final_reports",
    max_jobs: int = 64,
) -> list[_Job]:
    """Poll the three compute endpoints repeatedly until no job is pending
    (or max_jobs picked up). Each pickup PATCHes state 3 + stamps the lease
    — exactly the per-job prologue of the reference poll (compute_matches.py:
    42-52) — which removes it from the pending pool, so the SAME three
    one-job endpoints the reference consumes (api_repository.py:53-63)
    drain the whole queue with no extra API surface. Fatal-error jobs are
    failed to state 5 here and not returned."""
    jobs: list[_Job] = []
    while len(jobs) < max_jobs:
        updates_needed = query_updates.get_status()
        if updates_needed is None:
            break
        found = False
        for update_type, update_object in updates_needed.items():
            if update_object is None:
                continue
            found = True
            ticket = Ticket(update_object, client, report_dir)
            ticket.change_process_state(STATE_IN_PROGRESS)
            # lease breadcrumb: lets a later poll detect and reset this job
            # if the broker dies before the terminal PATCH (service/lease.py;
            # the reference left such jobs in state 3 forever, SURVEY.md §5.3)
            try:
                lease.stamp(client, ticket.query_id, update_type)
            except Exception as exc:  # the stamp must never kill the job
                log.warning("lease stamp failed for query %s: %s",
                            ticket.query_id, exc)

            fatal_error_message, error_message = ticket.catch_errors(update_type)
            if fatal_error_message:
                ticket.fail(fatal_error_message)
                continue
            if error_message:
                ticket.add_note(error_message)
            jobs.append(_Job(update_type, update_object, ticket,
                             _job_rng(seed, rng, update_object, update_type)))
            if len(jobs) >= max_jobs:
                break
        if not found:
            break
    return jobs


def compute_matches(
    query_updates: APIRepository,
    hyperparameters: HyperParams,
    *,
    rng: random.Random | None = None,
    seed=None,
    report_dir: str = "final_reports",
    exact: bool = False,
    index_cache: SearchSetCache | None = None,
    max_jobs_per_poll: int = 64,
) -> None:
    """Process every pending job this poll (reference compute_matches.py:8),
    batching concurrent queries over the same search set into one device
    program (see module docstring).

    exact=True runs the float64 host similarity path (reference-parity
    numerics; per-job, never batched). index_cache (optional) reuses device
    indexes across rounds of the same search set. seed enables
    order-independent per-job PRNGs (see _job_rng)."""
    jobs = drain_pending_jobs(
        query_updates, query_updates.client, rng=rng, seed=seed,
        report_dir=report_dir, max_jobs=max_jobs_per_poll,
    )
    if not jobs:
        return

    # -- per-job target estimation, drain order (API reads + per-job rng) ----
    ready: list[_Job] = []
    for job in jobs:
        try:
            estimate_target(job.ticket, job.update_object, hyperparameters,
                            rng=job.rng)
            job.ref_splits = job.ticket._target_splits
            ready.append(job)
        except Exception as exc:
            # transient failure: leave the job in state 3 for lease recovery
            # (parity with the reference, whose poll-level catch does the
            # same, broker.py:88-92) and keep processing the rest
            log.error("target estimation failed for query %s: %s",
                      job.ticket.query_id, exc, exc_info=True)

    # -- group by search set; ONE similarity program per group ---------------
    groups: dict[tuple, list[_Job]] = {}
    for job in ready:
        key = (job.ticket.search_set, tuple(hyperparameters.streams),
               tuple(sorted(job.ref_splits)), hyperparameters.feature_name)
        groups.setdefault(key, []).append(job)
    for (search_set, streams, splits, feature_name), gjobs in groups.items():
        try:
            index = _group_index(gjobs[0].ticket, hyperparameters, splits,
                                 exact, index_cache)
            engine = SearchEngine(index, exact=exact)
            big = (not exact
                   and index.n_padded >= SearchConfig().big_round_threshold)
            if exact:
                tables = [engine.compute_similarities(j.ticket.target_features)
                          for j in gjobs]
            else:
                tables = engine.compute_similarities_multi(
                    [j.ticket.target_features for j in gjobs], resident=big)
            for job, table in zip(gjobs, tables):
                job.table = table
            if big and len(gjobs) > 1:
                # big-corpus groups: run the whole group's optimizer gathers
                # and banded-candidate downloads as ONE program each (solo
                # they pay a dispatch and a download per query)
                _prepare_group_rounds(gjobs, hyperparameters)
        except Exception as exc:
            log.error("similarity pass failed for search set %s: %s",
                      search_set, exc, exc_info=True)

    # -- per-query round finish, drain order ---------------------------------
    for job in ready:
        if job.table is None:
            continue
        try:
            finish_job(job.ticket, job.update_type, job.update_object,
                       hyperparameters, job.table, rng=job.rng,
                       hp_round=job.hp_round, scores=job.scores)
        except Exception as exc:
            log.error("round finish failed for query %s: %s",
                      job.ticket.query_id, exc, exc_info=True)


def _group_index(ticket: Ticket, hp: HyperParams, splits: tuple,
                 exact: bool, index_cache: SearchSetCache | None
                 ) -> FeatureIndex:
    """Fetch/build (or cache-reuse) the device index for one search set."""
    def build_index() -> FeatureIndex:
        records = ticket.candidate_feature_records(hp)
        # Pad the clip axis to a coarse multiple so XLA compiles one program
        # per size bucket instead of one per exact search-set size (a
        # first compile costs seconds).
        return FeatureIndex.build(
            records, hp.streams, splits=list(splits),
            keep_host=exact, pad_multiple=512,
        )

    version = (ticket.search_set_version()
               if index_cache is not None else None)
    if index_cache is not None and version is not None:
        # version-keyed: a search set that grew between rounds changes its
        # version (one cheap read), so stale candidates are never served
        key = (ticket.search_set, version, tuple(hp.streams), splits,
               hp.feature_name, exact)
        return index_cache.get(key, build_index)
    # no version signal -> reference semantics: refetch every round
    # (ticket.py:358-382); a TTL-stale index must never be served
    return build_index()


def estimate_target(
    ticket: Ticket,
    update_object: Mapping[str, Any],
    hp: HyperParams,
    *,
    rng: random.Random | None = None,
) -> None:
    """Target estimation (reference compute_matches.py:55-56): sets
    ticket.target_features (and stashes the reference clip's splits)."""
    ref_features, ref_splits = ticket.clip_features(ticket.ref_clip_id, hp)
    estimator = TargetEstimator(hp, rng=rng)
    bootstrap = bool(ticket.dynamic_target_adjustment)
    previous_target = None
    valid_feats: list = []
    invalid_feats: list = []
    target_splits = ref_splits
    if ticket.latest_query_result:
        previous_target = ticket.latest_query_result.get("bootstrapped_target")
    if bootstrap and previous_target is not None:
        valid_feats, match_splits = ticket.match_features(True, hp)
        invalid_feats, _ = ticket.match_features(False, hp)
        if valid_feats:
            target_splits = match_splits
    ticket.target_features = estimator.estimate(
        ref_features, valid_feats, invalid_feats, target_splits,
        previous_target, bootstrap,
    )
    ticket._target_splits = ref_splits


def _reviewed_labels(ticket: Ticket) -> dict[int, float]:
    """Reviewed-match labels for the optimizer: user_match wins, else
    is_match (reference compute_matches.py:61-67 labeling)."""
    reviewed: dict[int, float] = {}
    for match in ticket.prior_matches:
        label = match["user_match"]
        if label is None:
            label = match["is_match"]
        reviewed[match["video_clip"]] = float(bool(label))
    return reviewed


def _round_spec(ticket: Ticket, update_type: str, hp_round) -> dict:
    """The banded-round parameters of one job (ResidentTable.round_scores
    argument set), shared by the solo and group-batched paths."""
    user_match_ids = [int(c) for c, v in ticket.user_matches.items()
                      if v is True]
    return {
        "weights": hp_round.weights,
        "threshold": hp_round.threshold,
        "near_miss": hp_round.near_miss_default,
        "keep_ids": [ticket.ref_clip_id] + user_match_ids,
        "user_match_ids": user_match_ids,
        "finalize": update_type == "finalize",
    }


def _prepare_group_rounds(gjobs, hp: HyperParams) -> None:
    """Group-batched round prep for a resident (big-corpus) poll group:
    sets job.hp_round and job.scores so finish_job skips its per-query
    device traffic. One gather program covers every optimizing job; one
    banded program per finalize-flavor covers every download — each solo
    equivalent pays a dispatch and a download per query."""
    from videoquery.search.engine import optimize_many, round_scores_many

    opt_jobs, opt_labels = [], []
    for job in gjobs:
        if job.update_type == "new" or not job.update_object["matches"]:
            job.hp_round = hp.reset_round_state()
        elif job.update_type in ("revise", "finalize"):
            opt_jobs.append(job)
            opt_labels.append(_reviewed_labels(job.ticket))
        # anything else: leave hp_round None; finish_job raises its
        # reference-parity "update type is invalid"
    if opt_jobs:
        results = optimize_many([j.table for j in opt_jobs], opt_labels, hp)
        for job, (hp_round, _grid) in zip(opt_jobs, results):
            job.hp_round = hp_round
    rjobs = [j for j in gjobs if j.hp_round is not None]
    specs = [_round_spec(j.ticket, j.update_type, j.hp_round) for j in rjobs]
    scores_list = round_scores_many([j.table for j in rjobs], specs)
    for job, scores in zip(rjobs, scores_list):
        if scores is None:  # band wider than every cap: full download
            scores = job.table.to_table().scores(job.hp_round.weights)
        job.scores = scores


def finish_job(
    ticket: Ticket,
    update_type: str,
    update_object: Mapping[str, Any],
    hp: HyperParams,
    table,
    *,
    rng: random.Random | None = None,
    hp_round=None,
    scores=None,
) -> None:
    """Everything after the similarity pass: hyperparameter round state,
    round persistence, scoring, selection, matches, report/finalize
    (reference compute_matches.py:61-107). hp_round/scores may be
    precomputed by the group-batched pass (_prepare_group_rounds)."""
    resident = table if isinstance(table, ResidentTable) else None

    # -- hyperparameter round state (compute_matches.py:61-67) ---------------
    if hp_round is None:
        if update_type == "new" or not update_object["matches"]:
            hp_round = hp.reset_round_state()
        elif update_type in ("revise", "finalize"):
            hp_round, _grid = table.optimize(_reviewed_labels(ticket), hp)
        else:
            raise Exception("update type is invalid")

    # -- persist round, score, select (compute_matches.py:70-89) -------------
    new_round = 1 if update_type == "new" else ticket.latest_query_result["round"] + 1
    new_result_id = ticket.create_query_result(new_round, hp_round)

    if scores is not None:
        ticket.scores = scores
    elif resident is not None:
        spec = _round_spec(ticket, update_type, hp_round)
        scores = resident.round_scores(
            spec["weights"], spec["threshold"], spec["near_miss"],
            spec["keep_ids"], spec["user_match_ids"],
            finalize=spec["finalize"],
        )
        if scores is None:  # band wider than every cap: full download
            scores = resident.to_table().scores(hp_round.weights)
        ticket.scores = scores
    else:
        ticket.scores = table.scores(hp_round.weights)
    if update_type == "finalize":
        max_number_matches = INFINITE_MATCHES
        low_score, _ = lowest_scoring_user_match(ticket.scores, ticket.user_matches)
        near_miss = finalize_near_miss(hp_round.threshold, low_score, compute_eps())
    else:
        max_number_matches = ticket.number_of_matches_to_review
        near_miss = hp_round.near_miss_default
    ticket.matches = select_clips_to_review(
        ticket.scores, ticket.user_matches, ticket.ref_clip_id,
        hp_round.threshold, max_number_matches, near_miss, rng=rng,
    )

    if not ticket.matches:
        catch_no_matches_error(ticket)
        return

    ticket.add_matches_to_database(new_result_id)

    if update_type == "finalize":
        ticket.create_final_report(hp_round, new_result_id)
        ticket.change_process_state(STATE_FINALIZED)
    else:
        ticket.change_process_state(STATE_PROCESSED)


def process_job(
    ticket: Ticket,
    update_type: str,
    update_object: Mapping[str, Any],
    hp: HyperParams,
    *,
    rng: random.Random | None = None,
    exact: bool = False,
    index_cache: SearchSetCache | None = None,
) -> None:
    """One job end-to-end (estimation -> similarity -> finish): the
    single-job path, kept for direct callers. compute_matches itself batches
    the similarity pass across jobs."""
    estimate_target(ticket, update_object, hp, rng=rng)
    index = _group_index(ticket, hp, tuple(sorted(ticket._target_splits)),
                         exact, index_cache)
    engine = SearchEngine(index, exact=exact)
    big = (not exact
           and index.n_padded >= SearchConfig().big_round_threshold)
    if exact:
        table = engine.compute_similarities(ticket.target_features)
    else:
        [table] = engine.compute_similarities_multi(
            [ticket.target_features], resident=big)
    finish_job(ticket, update_type, update_object, hp, table, rng=rng)


def catch_no_matches_error(ticket: Ticket) -> None:
    """Zero matches is a job-level error (compute_matches.py:110-114)."""
    mround = (
        ticket.latest_query_result["round"] if ticket.latest_query_result else 1
    )
    ticket.fail(
        "*** Error: No matches were found for round {} of query {}! ***".format(
            mround, ticket.query_id
        )
    )
