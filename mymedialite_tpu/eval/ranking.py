"""Item-recommendation (ranking) evaluation.

Counterpart of reference ``Eval/Items.cs:62-209``. The reference's
per-user ``Parallel.ForEach`` + per-candidate ``Predict`` + IntervalHeap
becomes: batched full-catalog scoring on device ([B, f] x [f, N] matmul
inside the model's ``score_catalog``) + host-side vectorized rank math.

Protocol parity notes:
- candidate modes TRAINING/TEST/OVERLAP/UNION/EXPLICIT (Items.cs:62-96)
- per-user skip rules: no correct items, or correct == all effective
  candidates (Items.cs:152-163)
- correct_items = test ∩ candidates, *including* items also in the
  training ignore set (they count in AP/NDCG/recall denominators and in
  the AUC missing-relevant correction but can never be hits) — exactly
  the reference's semantics, which also means the n=-1 evaluation
  raises if a user's train/test items overlap (the reference throws
  "Should not happen" in AUC.cs:64 in that case).
- measures averaged over evaluated users (Items.cs:202-208).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from mymedialite_tpu.eval.measures import idcg
from mymedialite_tpu.eval.results import ItemRecommendationResults

CANDIDATE_MODES = ("TRAINING", "TEST", "OVERLAP", "UNION", "EXPLICIT")

import functools


@functools.lru_cache(maxsize=64)
def _rank_kernel(score_fn, num_items):
    """Jitted fused scorer+ranker, cached by (scorer fn, catalog size) so
    repeated evaluations (--find-iter, CV folds) reuse compiles.

    With ``score_fn`` (a model's pure catalog scorer), the whole batch —
    score, candidate/ignore masking, stable descending rank, gather of
    the correct items' ranks — is ONE jitted device call; the only
    device->host transfer is the small [B, P2] rank matrix, instead of
    one dispatch per eager op. Scoring runs at the default matmul
    precision (TF32 on GPUs that have it): ranking metrics then agree
    with a float32 reference within a tolerance, not bit for bit.
    With ``score_fn=None``, the second argument
    carries precomputed scores (host-scoring models)."""
    import jax
    import jax.numpy as jnp

    def impl(params, users_or_scores, cand_mask, ignore_rows, correct_rows):
        if score_fn is None:
            scores = users_or_scores
        else:
            scores = score_fn(params, users_or_scores)
        if scores.shape[1] < num_items:
            # items unknown to the model rank last, deterministically
            scores = jnp.pad(scores,
                             ((0, 0), (0, num_items - scores.shape[1])),
                             constant_values=-1e30)
        s = jnp.where(cand_mask[None, :], scores, -jnp.inf)
        B, P = ignore_rows.shape
        rows = jnp.repeat(jnp.arange(B, dtype=jnp.int32), P)
        s = s.at[rows, ignore_rows.reshape(-1)].set(-jnp.inf, mode="drop")
        # Rank of each correct item by comparison counting instead of a
        # full [B, N] argsort (counting is one streaming pass over the
        # scores): the stable descending rank equals (# items with higher
        # score) + (# items with equal score and smaller index) —
        # including the -inf ties an argsort gives masked correct items.
        cc = jnp.clip(correct_rows, 0, num_items - 1)
        sc = jnp.take_along_axis(s, cc, axis=1)              # [B, P2]
        P2 = cc.shape[1]
        T = 4096 if num_items >= 4096 else -(-num_items // 8) * 8
        n_pad = -(-num_items // T) * T
        # pad scores with -inf: a padded j never outranks a correct item
        # (-inf > sc is false; the equal--inf case fails j < cc since
        # padded j >= num_items > cc)
        s_pad = jnp.pad(s, ((0, 0), (0, n_pad - num_items)),
                        constant_values=-jnp.inf)

        def tile_step(counts, t):
            sl = jax.lax.dynamic_slice(s_pad, (0, t * T), (B, T))
            idx = t * T + jnp.arange(T, dtype=jnp.int32)
            gt = sl[:, :, None] > sc[:, None, :]
            eq = (sl[:, :, None] == sc[:, None, :]) & \
                (idx[None, :, None] < cc[:, None, :])
            counts = counts + jnp.sum(gt, axis=1) + jnp.sum(eq, axis=1)
            return counts, None

        counts, _ = jax.lax.scan(
            tile_step, jnp.zeros((B, P2), jnp.int32),
            jnp.arange(n_pad // T, dtype=jnp.int32))
        return jnp.where(correct_rows < num_items, counts, num_items)

    return jax.jit(impl)


def candidates_for_mode(mode: str, test, training,
                        explicit: Optional[Sequence[int]] = None) -> np.ndarray:
    """Candidate item set (reference Items.Candidates, Eval/Items.cs:62-96)."""
    mode = mode.upper()
    test_items = test.all_items if test is not None else np.array([], dtype=np.int32)
    if mode == "TRAINING":
        return np.asarray(training.all_items)
    if mode == "TEST":
        return np.asarray(test_items)
    if mode == "OVERLAP":
        return np.intersect1d(test_items, training.all_items)
    if mode == "UNION":
        return np.union1d(test_items, training.all_items)
    if mode == "EXPLICIT":
        if explicit is None:
            raise ValueError("EXPLICIT mode requires a candidate_items list")
        return np.unique(np.asarray(list(explicit), dtype=np.int64))
    raise ValueError(f"Unknown candidate_item_mode: {mode}")


def _user_measures(ranks_sorted: np.ndarray, m: int, n_cand: int, cutoff: int):
    """All per-user measures from the sorted 0-based ranks of the user's
    correct items within the valid-candidate ranking.

    ranks_sorted: ranks of correct∩valid items (ascending). Correct items
    that are not in the valid set (ignored train∩test items) have no rank
    and appear only via ``m``.
    m: |correct| (incl. unrankable ones)
    n_cand: |candidates - ignore| (length of the full ranking)
    cutoff: list length L (n_cand when n=-1, else min(n, n_cand))
    """
    L = cutoff
    dropped = n_cand - L
    in_list = ranks_sorted[ranks_sorted < L]
    m_in = int(in_list.size)

    out = {}
    # AUC with dropped-items correction (AUC.cs:42-68)
    num_eval_pairs = (n_cand - m_in) * m_in
    if num_eval_pairs == 0:
        out["AUC"] = 0.5
    else:
        k = np.arange(m_in)
        correct_pairs = int(np.sum((L - 1 - in_list) - (m_in - 1 - k)))
        missing_relevant = m - m_in
        if dropped - missing_relevant < 0:
            raise ValueError(
                "more missing relevant items than dropped items — "
                "train/test overlap with full-list evaluation (reference "
                "AUC.cs:64 'Should not happen')")
        correct_pairs += m_in * (dropped - missing_relevant)
        out["AUC"] = correct_pairs / num_eval_pairs
    # AP (PrecisionAndRecall.cs:45-66)
    if m_in:
        out["MAP"] = float(np.sum(np.arange(1, m_in + 1) / (in_list + 1)) / m)
    else:
        out["MAP"] = 0.0
    # NDCG (NDCG.cs:36-55)
    out["NDCG"] = float(np.sum(1.0 / np.log2(in_list + 2)) / idcg(m))
    # MRR (ReciprocalRank.cs:39-56)
    out["MRR"] = 1.0 / (in_list[0] + 1) if m_in else 0.0
    # prec@/recall@ (PrecisionAndRecall.cs:68-141)
    for N in (5, 10):
        hits = int(np.sum(in_list < min(N, L)))
        out[f"prec@{N}"] = hits / N
        out[f"recall@{N}"] = hits / m
    return out


def _measures_batch(ranks, m_arr, n_cand_arr, n, sums):
    """Vectorized ``_user_measures`` over a [B, P2] rank matrix (the
    per-user loop was the steady-state bottleneck of ranking eval at
    bench scale). Rows hold the kernel's ranks for each user's correct
    slots; pad slots return num_items-scale sentinels that sort past
    every real rank. Accumulates measure sums into ``sums`` and returns
    the number of evaluated users. Exactness vs the scalar path is
    covered by tests (test_measures.py)."""
    B, P2 = ranks.shape
    m = m_arr.astype(np.int64)
    n_cand = n_cand_arr.astype(np.int64)
    ok = (m > 0) & (m != n_cand)       # reference Items.cs:152-163
    if not ok.any():
        return 0
    ranks = np.sort(ranks, axis=1).astype(np.int64)
    slot = np.arange(P2, dtype=np.int64)[None, :]
    L = n_cand if n < 0 else np.minimum(n, n_cand)
    valid = slot < m[:, None]
    in_mask = valid & (ranks < L[:, None])
    m_in = in_mask.sum(axis=1)
    m_safe = np.maximum(m, 1)

    # AUC with dropped-items correction (AUC.cs:42-68); sorted ranks
    # make the in-list exactly the first m_in valid slots, so the
    # in-list position k equals the slot index
    dropped = n_cand - L
    pairs = (n_cand - m_in) * m_in
    term = np.where(in_mask,
                    (L[:, None] - 1 - ranks) - (m_in[:, None] - 1 - slot),
                    0)
    missing_relevant = m - m_in
    bad = ok & (pairs > 0) & (dropped - missing_relevant < 0)
    if bad.any():
        raise ValueError(
            "more missing relevant items than dropped items — "
            "train/test overlap with full-list evaluation (reference "
            "AUC.cs:64 'Should not happen')")
    correct_pairs = term.sum(axis=1) + m_in * (dropped - missing_relevant)
    auc = np.where(pairs > 0, correct_pairs / np.maximum(pairs, 1), 0.5)

    # AP (PrecisionAndRecall.cs:45-66)
    ap = np.where(in_mask, (slot + 1) / (ranks + 1.0), 0.0).sum(axis=1) \
        / m_safe
    # NDCG (NDCG.cs:36-55): idcg via one cumulative table over max m
    dcg = np.where(in_mask, 1.0 / np.log2(ranks + 2.0), 0.0).sum(axis=1)
    max_m = int(m.max())
    idcg_tab = np.concatenate(
        [[1.0], np.cumsum(1.0 / np.log2(np.arange(max_m) + 2))])
    ndcg = dcg / idcg_tab[np.minimum(m, max_m)]
    # MRR (ReciprocalRank.cs:39-56): smallest rank = sorted slot 0
    mrr = np.where(m_in > 0, 1.0 / (ranks[:, 0] + 1.0), 0.0)

    okf = ok.astype(np.float64)
    sums["AUC"] += float((auc * okf).sum())
    sums["MAP"] += float((ap * okf).sum())
    sums["NDCG"] += float((ndcg * okf).sum())
    sums["MRR"] += float((mrr * okf).sum())
    # prec@/recall@ (PrecisionAndRecall.cs:68-141)
    for N in (5, 10):
        cut = np.minimum(N, L)
        hits = (valid & (ranks < cut[:, None])).sum(axis=1)
        sums[f"prec@{N}"] += float((hits / N * okf).sum())
        sums[f"recall@{N}"] += float((hits / m_safe * okf).sum())
    return int(ok.sum())


def evaluate_items(recommender, test, training,
                   test_users: Optional[Sequence[int]] = None,
                   candidate_items: Optional[Sequence[int]] = None,
                   candidate_item_mode: str = "OVERLAP",
                   repeated_events: bool = False,
                   n: int = -1,
                   batch_size: int = 512) -> ItemRecommendationResults:
    """Ranking evaluation (reference Eval/Items.Evaluate, Items.cs:126-209)."""
    if test_users is None:
        test_users = test.all_users
    test_users = np.asarray(test_users, dtype=np.int32)
    cand = candidates_for_mode(candidate_item_mode, test, training,
                               candidate_items)

    num_items = max(recommender.num_items_trained,
                    int(cand.max()) + 1 if cand.size else 0,
                    training.num_items, test.num_items)
    cand_mask = np.zeros(num_items, dtype=bool)
    cand_mask[cand] = True
    num_candidates = int(cand_mask.sum())

    sums = {m: 0.0 for m in ItemRecommendationResults.ALL_MEASURES}
    num_evaluated = 0

    import jax
    import jax.numpy as jnp
    cand_mask_dev = jnp.asarray(cand_mask)

    scorer = recommender.catalog_scorer()
    if scorer is not None:
        score_fn, score_params = scorer
    else:
        score_fn, score_params = None, None
    rank_kernel = _rank_kernel(score_fn, num_items)

    # multi-device: data-parallel over test users (SURVEY §2.9 P4, the
    # counterpart of the reference's Parallel.ForEach, Eval/Items.cs:147) —
    # shard the user batch + index matrices over the mesh and let XLA's
    # SPMD partitioner split the fused score+rank kernel; params and the
    # candidate mask replicate.
    mesh = None
    if score_fn is not None and len(jax.devices()) > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from mymedialite_tpu.parallel.mesh import make_mesh
        mesh = make_mesh()
        n_dev = mesh.devices.size
        batch_size = max(-(-batch_size // n_dev), 1) * n_dev
        _row = NamedSharding(mesh, P("data"))
        _row2 = NamedSharding(mesh, P("data", None))
        _rep = NamedSharding(mesh, P())
        cand_mask_dev = jax.device_put(np.asarray(cand_mask), _rep)
        score_params = jax.device_put(score_params, _rep)

    def _put(arr):
        """Device placement for a batch-dim array (sharded under a mesh)."""
        if mesh is None:
            return jnp.asarray(arr)
        a = np.asarray(arr)
        return jax.device_put(a, _row if a.ndim == 1 else _row2)

    def _bucket(size):
        # power-of-two width buckets keep the jitted rank kernel's shape
        # set small (otherwise every batch's max history length is a new
        # shape -> recompile)
        return 1 << max(0, int(size - 1).bit_length())

    # batch-vectorized host prep over the CSR index (a per-user python
    # loop with np.unique per user was the host-side bottleneck at
    # bench scale — it serialized against the device pipeline)
    cand_mask_ext = np.append(cand_mask, False)  # safe at pad num_items
    te_csr = test.by_user
    tr_csr = None if repeated_events else training.by_user

    def _ragged_rows(csr, batch, num_rows, P):
        """[B, P] padded per-user sorted item rows from the CSR (pad =
        num_items, out-of-range for the kernel); users >= num_rows get
        empty rows."""
        B = batch.size
        if num_rows == 0:
            return np.full((B, P), num_items, np.int32)
        u = np.minimum(batch.astype(np.int64), num_rows - 1)
        valid = batch < num_rows
        starts = np.where(valid, csr.indptr[u], 0)
        cnt = np.where(valid, (csr.indptr[u + 1] - csr.indptr[u]), 0)
        out = np.full((B, P), num_items, np.int32)
        total = int(cnt.sum())
        if total:
            row_rep = np.repeat(np.arange(B), cnt)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(cnt) - cnt, cnt)
            out[row_rep, within] = csr.keys[np.repeat(starts, cnt) + within]
        return out

    def _col_width(csr, us, num_rows):
        """One global row width per evaluate call (bucketed max history
        over ALL test users): per-batch widths varied with each batch's
        max and recompiled the rank kernel mid-eval."""
        if num_rows == 0 or us.size == 0:
            return 1
        u = np.minimum(us.astype(np.int64), num_rows - 1)
        cnt = np.where(us < num_rows,
                       csr.indptr[u + 1] - csr.indptr[u], 0)
        return _bucket(int(cnt.max()))

    P_ignore = 1 if tr_csr is None else \
        _col_width(tr_csr, test_users, training.num_users)
    P_correct = _col_width(te_csr, test_users, test.num_users)

    def _uniq_mask(mat):
        """First occurrence of each real item per (sorted) row."""
        keep = mat < num_items
        keep[:, 1:] &= mat[:, 1:] != mat[:, :-1]
        return keep

    def batch_prep(batch):
        """Vectorized equivalent of the reference's per-user prep
        (Eval/Items.cs:138-167): per-user unique train-item ignore rows,
        unique correct (test ∩ candidates) rows compacted to the row
        front, and effective candidate counts."""
        if tr_csr is not None:
            tmat = _ragged_rows(tr_csr, batch, training.num_users,
                                P_ignore)
            tkeep = _uniq_mask(tmat)
            ignore_rows = np.where(tkeep, tmat, num_items)
            ignored_in_cand = (tkeep & cand_mask_ext[tmat]).sum(axis=1)
        else:
            ignore_rows = np.full((batch.size, 1), num_items, np.int32)
            ignored_in_cand = np.zeros(batch.size, np.int64)
        n_cand_arr = num_candidates - ignored_in_cand

        cmat = _ragged_rows(te_csr, batch, test.num_users, P_correct)
        ckeep = _uniq_mask(cmat) & cand_mask_ext[cmat]
        correct_rows = np.where(ckeep, cmat, num_items)
        correct_rows.sort(axis=1)  # kept items compact to the front
        m_arr = ckeep.sum(axis=1)
        return ignore_rows, correct_rows, m_arr, n_cand_arr

    # Phase 1: prep + dispatch every batch WITHOUT fetching — the device
    # pipelines the fused kernels while the host
    # preps the next batch; fetching per batch would serialize host prep,
    # round-trip latency, and device compute.
    pending = []
    for start in range(0, test_users.size, batch_size):
        batch = test_users[start:start + batch_size]
        nreal = batch.size
        if test_users.size > batch_size:
            target = batch_size  # fixed batch shape across the loop
        elif mesh is not None:
            target = max(-(-nreal // n_dev) * n_dev, n_dev)
        else:
            target = nreal
        if nreal < target:
            # pad the ragged tail with the last user
            batch = np.concatenate(
                [batch, np.full(target - nreal, batch[-1],
                                dtype=batch.dtype)])
        if score_fn is not None:
            # scoring fuses into the rank kernel (one jitted call)
            scores_in = _put(batch.astype(np.int32))
        else:
            # host-scoring models: one transfer per batch
            scores_in = jnp.asarray(
                np.asarray(recommender.score_catalog(batch),
                           dtype=np.float32))

        # padded rectangular index matrices; pad value num_items is
        # out-of-range (NEVER -1: jax wraps negative indices)
        ignore_rows, correct_rows, m_arr, n_cand_arr = batch_prep(batch)
        pending.append((rank_kernel(
            score_params, scores_in, cand_mask_dev,
            _put(ignore_rows), _put(correct_rows)),
            m_arr, n_cand_arr, nreal))

    # Phase 2: fetch + vectorized rank math. Group pending rank
    # matrices by width and fetch each group as ONE device->host
    # transfer instead of one synchronising fetch per batch.
    groups = {}
    for entry in pending:
        groups.setdefault(entry[0].shape[1], []).append(entry)
    for items in groups.values():
        if len(items) > 1:
            ranks_all = np.asarray(
                jnp.concatenate([it[0] for it in items], axis=0))
        else:
            ranks_all = np.asarray(items[0][0])
        sel, m_l, nc_l = [], [], []
        off = 0
        for ranks_dev, m_arr, n_cand_arr, nreal in items:
            sel.append(np.arange(off, off + nreal))
            m_l.append(m_arr[:nreal])
            nc_l.append(n_cand_arr[:nreal])
            off += ranks_dev.shape[0]
        # ranks of ignored (train∩test) correct items are >= n_cand and
        # fall out of the in-list filter inside _measures_batch
        num_evaluated += _measures_batch(
            ranks_all[np.concatenate(sel)], np.concatenate(m_l),
            np.concatenate(nc_l), n, sums)

    result = ItemRecommendationResults()
    for key in sums:
        result[key] = sums[key] / num_evaluated if num_evaluated else 0.0
    result["num_users"] = num_evaluated
    result["num_lists"] = num_evaluated
    result["num_items"] = int(cand.size)
    return result
