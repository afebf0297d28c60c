"""Full-catalog top-K scoring / retrieval.

JAX replacement for the reference's per-candidate Predict loop +
C5 IntervalHeap (``Recommender.cs:52-103``): one [B, f] x [f, N]
matmul per user block, per-user ignore masks applied on device, then
``jax.lax.top_k``. This is the serving-path kernel of the BASELINE.json
north star.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = jnp.float32(-3.0e38)


@functools.partial(jax.jit, static_argnames=("k",))
def topk_from_factors(user_rows, item_table, ignore_rows, cand_mask, *,
                      k: int):
    """Top-k items for a block of users.

    user_rows:  [B, f] gathered user factors (fused tables work too).
    item_table: [N, f].
    ignore_rows: [B, P] int32 per-user items to exclude; pad with a
                 POSITIVE out-of-range id (>= N). Negative ids would wrap
                 to the end of the table in jax indexing.
    cand_mask:  [N] float32 1/0 candidate mask (all-ones for full catalog).
    Returns (ids [B, k], scores [B, k]).
    """
    scores = jnp.dot(user_rows, item_table.T,
                     preferred_element_type=jnp.float32)  # [B, N]
    scores = jnp.where(cand_mask[None, :] > 0, scores, NEG_INF)
    B = scores.shape[0]
    if ignore_rows.shape[1] > 0:
        rows = jnp.repeat(jnp.arange(B, dtype=jnp.int32),
                          ignore_rows.shape[1])
        cols = ignore_rows.reshape(-1)
        scores = scores.at[rows, cols].set(NEG_INF, mode="drop")
    top_scores, top_ids = jax.lax.top_k(scores, k)
    return top_ids, top_scores


def recommend_batch(recommender, users, n: int, training=None,
                    candidates=None, block: int = 1024):
    """Batched top-n recommendation with per-user training-item exclusion
    (the serving analog of per-user ``recommend``). Returns
    (ids [len(users), n], scores) numpy arrays; slots past the number of
    scoreable items hold id -1."""
    users = np.asarray(users, dtype=np.int32)
    num_items = recommender.num_items_trained
    cand_mask = np.ones(num_items, dtype=np.float32)
    if candidates is not None:
        cand_mask[:] = 0.0
        cand = np.asarray(list(candidates), dtype=np.int64)
        cand_mask[cand[(cand >= 0) & (cand < num_items)]] = 1.0
    cand_mask = jnp.asarray(cand_mask)

    out_ids = np.empty((users.size, n), dtype=np.int32)
    out_scores = np.empty((users.size, n), dtype=np.float32)
    for start in range(0, users.size, block):
        batch = users[start:start + block]
        scores = jnp.asarray(recommender.score_catalog(batch))
        if training is not None:
            P = max((int(training.count_by_user[batch].max())
                     if batch.size else 1), 1)
            ignore = np.full((batch.size, P), num_items, dtype=np.int32)
            for r, u in enumerate(batch):
                if u < training.num_users:
                    items_u = training.items_by_user(int(u))
                    ignore[r, :items_u.size] = items_u
            rows = jnp.repeat(jnp.arange(batch.size, dtype=jnp.int32), P)
            scores = scores.at[rows, jnp.asarray(ignore).reshape(-1)].set(
                NEG_INF, mode="drop")
        scores = jnp.where(cand_mask[None, :] > 0, scores, NEG_INF)
        s, ids = jax.lax.top_k(scores, min(n, num_items))
        s = np.array(s)
        ids = np.array(ids)
        if ids.shape[1] < n:
            pad = n - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
            s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
        ids[s <= float(NEG_INF)] = -1
        out_ids[start:start + block] = ids
        out_scores[start:start + block] = s
    return out_ids, out_scores
