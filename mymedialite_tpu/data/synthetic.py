"""Synthetic dataset generators for tests and benchmarks.

The environment has no network egress, so MovieLens/Netflix can't be
downloaded; these generators produce datasets with MovieLens-like
statistics (power-law item popularity, per-user activity spread, a
low-rank latent structure in the ratings) so that quality numbers are
meaningful: a factor model should beat the global-average baseline by a
clear margin on held-out data iff it actually learns.
"""

from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from mymedialite_tpu.data.arrays import PosOnlyData, RatingData


def synthetic_ratings(num_users: int = 943, num_items: int = 1682,
                      num_ratings: int = 100_000, rank: int = 8,
                      noise: float = 0.6, seed: int = 42,
                      with_times: bool = False,
                      time_drift: float = 0.0,
                      return_factors: bool = False):
    """Low-rank-plus-biases rating generator on a 1..5 scale.

    ``time_drift`` > 0 (with ``with_times``) adds a per-item linear
    temporal drift of that magnitude to the true score — gives the
    time-aware baselines (Koren 2009 temporal dynamics) real signal to
    model. ``return_factors`` additionally returns the planted
    (P, Q, b_u, b_i) — used e.g. to derive a factor-consistent social
    trust graph for SocialMF quality rows."""
    rng = np.random.default_rng(seed)
    # popularity: Zipf-ish item distribution, log-normal user activity
    item_p = 1.0 / np.arange(1, num_items + 1) ** 0.8
    item_p /= item_p.sum()
    user_p = rng.lognormal(0.0, 1.0, num_users)
    user_p /= user_p.sum()
    users = rng.choice(num_users, size=num_ratings, p=user_p).astype(np.int32)
    items = rng.choice(num_items, size=num_ratings, p=item_p).astype(np.int32)
    # dedup (u,i) pairs, keep first occurrence
    _, first = np.unique(users.astype(np.int64) * num_items + items,
                         return_index=True)
    first = np.sort(first)
    users, items = users[first], items[first]
    n = users.size

    P = rng.normal(0, 1.0 / np.sqrt(rank), (num_users, rank))
    Q = rng.normal(0, 1.0 / np.sqrt(rank), (num_items, rank))
    bu = rng.normal(0, 0.35, num_users)
    bi = rng.normal(0, 0.35, num_items)
    raw = 3.6 + bu[users] + bi[items] + np.einsum(
        "nf,nf->n", P[users], Q[items]) * 1.2 + rng.normal(0, noise, n)
    times = None
    if with_times:
        times = rng.integers(880_000_000, 893_000_000, n)
        if time_drift:
            d_i = rng.normal(0, 1.0, num_items)
            t_norm = (times - 880_000_000) / 13_000_000.0
            raw = raw + time_drift * (t_norm - 0.5) * d_i[items]
    values = np.clip(np.round(raw * 2) / 2, 1.0, 5.0)  # half-star scale
    data = RatingData(users, items, values, num_users=num_users,
                      num_items=num_items, times=times)
    if return_factors:
        return data, (P, Q, bu, bi)
    return data


# The scaled generator's planted structure: latent rank and rating noise
# as in ``synthetic_ratings``; the share of a user's items drawn from its
# own taste group, and the rating bonus on that group.
_RANK = 8
_NOISE = 0.6
_TASTE_SHARE = 0.8
_TASTE_BONUS = 0.5


def _cdf(weights):
    """Integer CDF of ``weights`` over 2^30: exact cumulative sums, so
    even the lightest of 10^5..10^6 ids keeps its share (a float32 CDF
    rounds shares below its top ulp)."""
    scaled = jnp.round(weights * (2.0 ** 30 / jnp.sum(weights)))
    return jnp.cumsum(scaled.astype(jnp.int32))


def _zipf_cdf(n: int):
    return _cdf(1.0 / jnp.arange(1, n + 1, dtype=jnp.float32) ** 0.8)


def _inverse_cdf(key, cdf, m: int):
    """m ids drawn with the probabilities that ``cdf`` holds."""
    r = jax.random.randint(key, (m,), 0, cdf[-1])
    return jnp.searchsorted(cdf, r, side="right").astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("num_users", "num_items",
                                             "num_tastes"))
def _tables(key, *, num_users: int, num_items: int, num_tastes: int):
    """Per-user activity CDF and taste group, item popularity CDFs."""
    k_user, k_taste = jax.random.split(key)
    return dict(
        user_cdf=_cdf(jnp.exp(jax.random.normal(k_user, (num_users,)))),
        taste=jax.random.randint(k_taste, (num_users,), 0, num_tastes),
        item_cdf=_zipf_cdf(num_items),
        group_cdf=_zipf_cdf(-(-num_items // num_tastes)))


@functools.partial(jax.jit, static_argnames=("m", "num_items", "num_tastes",
                                             "uniform"))
def _add_draws(key, u, i, tables, *, m: int, num_items: int,
               num_tastes: int, uniform: bool):
    """Draw m (user, item) pairs: users by activity; items by the user's
    taste group, else by global popularity (or catalog-uniform). Returns
    them with the pairs so far, sorted by (user, item), a mask of the
    first copy of each pair, and the number of distinct pairs."""
    k_user, k_own, k_pick, k_item = jax.random.split(key, 4)
    du = _inverse_cdf(k_user, tables["user_cdf"], m)
    if uniform:
        di = jax.random.randint(k_item, (m,), 0, num_items)
    else:
        own = tables["taste"][du] + num_tastes * _inverse_cdf(
            k_own, tables["group_cdf"], m)
        pick = (jax.random.uniform(k_pick, (m,)) < _TASTE_SHARE) & \
            (own < num_items)
        di = jnp.where(pick, own,
                       _inverse_cdf(k_item, tables["item_cdf"], m))
    u, i = jax.lax.sort((jnp.concatenate([u, du]), jnp.concatenate([i, di])),
                        num_keys=2)
    first = jnp.ones(u.shape, bool).at[1:].set(
        (u[1:] != u[:-1]) | (i[1:] != i[:-1]))
    return u, i, first, jnp.sum(first)


@functools.partial(jax.jit, static_argnames=("size",))
def _compact(u, i, first, *, size: int):
    keep = jnp.nonzero(first, size=size)[0]
    return u[keep], i[keep]


@functools.partial(jax.jit, static_argnames=("num_ratings", "num_probe",
                                             "num_items", "num_tastes"))
def _finish(key, u, i, taste, *, num_ratings: int, num_probe: int,
            num_items: int, num_tastes: int):
    """Keep ``num_ratings + num_probe`` of the distinct pairs at random
    (in (user, item) order), score them on a half-star 1..5 scale (low
    rank plus biases, a taste-group bonus, Gaussian noise) and split off
    a random probe. Returns ``(train, probe)`` (users, items, values)."""
    k_pick, k_p, k_q, k_bu, k_bi, k_noise, k_probe = jax.random.split(key, 7)
    need = num_ratings + num_probe
    keep = jnp.sort(jax.random.permutation(k_pick, u.size)[:need])
    u, i = u[keep], i[keep]
    num_users = taste.size
    P = jax.random.normal(k_p, (num_users, _RANK)) / np.sqrt(_RANK)
    Q = jax.random.normal(k_q, (num_items, _RANK)) / np.sqrt(_RANK)
    bu = 0.35 * jax.random.normal(k_bu, (num_users,))
    bi = 0.35 * jax.random.normal(k_bi, (num_items,))
    raw = (3.6 + bu[u] + bi[i]
           + _TASTE_BONUS * (taste[u] == i % num_tastes)
           + jnp.sum(P[u] * Q[i], axis=1) * 1.2
           + _NOISE * jax.random.normal(k_noise, u.shape))
    values = jnp.clip(jnp.round(raw * 2) / 2, 1.0, 5.0)
    probe = jnp.zeros(need, bool).at[
        jax.random.permutation(k_probe, need)[:num_probe]].set(True)
    parts = []
    for mask, size in ((~probe, num_ratings), (probe, num_probe)):
        idx = jnp.nonzero(mask, size=size)[0]
        parts.append((u[idx], i[idx], values[idx]))
    return parts


def synthetic_ratings_at_scale(num_users: int, num_items: int,
                               num_ratings: int, num_probe: int = 0, *,
                               num_tastes: int = 64, seed: int = 42):
    """``synthetic_ratings``' statistics (Zipf item popularity,
    log-normal user activity, low rank plus biases, half-star 1..5
    scale) at 10^7..10^8 ratings: exactly ``num_ratings`` distinct
    training pairs plus a disjoint probe of ``num_probe`` pairs.

    Which items a user rates depends on the user, as in real data: each
    user has one of ``num_tastes`` taste groups (items are dealt into
    groups by popularity rank), draws most of its items Zipf-distributed
    within its group and the rest from global popularity, and rates its
    own group higher. So a personalised ranker can beat popularity,
    which it cannot when item choice ignores the user. Once the draws
    saturate (a pass yields under a quarter new pairs, as heavy users
    exhaust their group at 10^8 ratings) the remaining pairs take
    catalog-uniform items.

    The draws, the deduplication (a sort of the pairs) and the scoring
    run on the default device with ``jax.random``, which gives the same
    bits on every backend; only the result is fetched to the host.
    Returns ``(train, probe)`` RatingData, each sorted by user."""
    k_tables, k_draw, k_finish = jax.random.split(jax.random.key(seed), 3)
    tables = _tables(k_tables, num_users=num_users, num_items=num_items,
                     num_tastes=num_tastes)
    need = num_ratings + num_probe
    u = i = jnp.zeros(0, jnp.int32)
    new_per_draw = 1.0      # the last pass's share of new distinct pairs
    for step in itertools.count():
        if u.size >= need:
            break
        m = int((need - u.size) * 1.25 / new_per_draw) + 1024
        before = u.size
        u, i, first, count = _add_draws(
            jax.random.fold_in(k_draw, step), u, i, tables, m=m,
            num_items=num_items, num_tastes=num_tastes,
            uniform=new_per_draw < 0.25)
        u, i = _compact(u, i, first, size=int(count))
        new_per_draw = (u.size - before) / m
    parts = _finish(k_finish, u, i, tables["taste"], num_ratings=num_ratings,
                    num_probe=num_probe, num_items=num_items,
                    num_tastes=num_tastes)
    return tuple(
        RatingData(*(np.asarray(x) for x in part), num_users=num_users,
                   num_items=num_items)
        for part in parts)


def write_rating_files(train_path: str, test_path: str, *,
                       num_users: int, num_items: int, num_ratings: int,
                       num_test: int, seed: int = 42):
    """Write a seeded ``user<TAB>item<TAB>rating`` train/test file pair
    in the reference's example format. Every test rating's user and
    item also occur in the training file."""
    data = synthetic_ratings(num_users=num_users, num_items=num_items,
                             num_ratings=num_ratings, seed=seed)
    rng = np.random.default_rng(seed + 1)
    users, items = np.asarray(data.users), np.asarray(data.items)
    cu = np.bincount(users, minlength=num_users)
    ci = np.bincount(items, minlength=num_items)
    test = np.zeros(len(data), bool)
    picked = 0
    for k in rng.permutation(len(data)):
        if picked == num_test:
            break
        if cu[users[k]] > 1 and ci[items[k]] > 1:
            test[k] = True
            picked += 1
            cu[users[k]] -= 1
            ci[items[k]] -= 1
    for path, mask in ((train_path, ~test), (test_path, test)):
        rows = np.column_stack([users[mask], items[mask],
                                np.asarray(data.values)[mask]])
        np.savetxt(path, rows, fmt="%d\t%d\t%g")


def synthetic_posonly(num_users: int = 943, num_items: int = 1682,
                      num_events: int = 50_000, rank: int = 8,
                      seed: int = 7) -> PosOnlyData:
    """Implicit feedback where 'likes' follow a latent low-rank preference,
    so ranking models can achieve AUC well above 0.5."""
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 1, (num_users, rank)).astype(np.float32)
    Q = rng.normal(0, 1, (num_items, rank)).astype(np.float32)
    pop = rng.normal(0, 1, num_items).astype(np.float32)
    user_p = rng.lognormal(0.0, 1.0, num_users)
    user_p /= user_p.sum()
    users = rng.choice(num_users, size=num_events * 2, p=user_p).astype(np.int32)
    # sample items per event from softmax(popularity + affinity) via the
    # Gumbel trick, chunked to bound the [chunk, num_items] temporary
    items = np.empty(users.size, dtype=np.int32)
    # affinity dominates popularity so factor models beat raw popularity
    scale = np.float32(2.0 / np.sqrt(rank))
    for s in range(0, users.size, 4096):
        chunk = users[s:s + 4096]
        logits = P[chunk] @ Q.T * scale + 0.5 * pop[None, :]
        g = rng.gumbel(size=logits.shape).astype(np.float32)
        items[s:s + 4096] = np.argmax(logits + g, axis=1)
    _, first = np.unique(users.astype(np.int64) * num_items + items,
                         return_index=True)
    first = np.sort(first)[:num_events]
    return PosOnlyData(users[first], items[first], num_users=num_users,
                       num_items=num_items)


def split_ratings(data: RatingData, test_fraction: float = 0.2, seed: int = 1):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data))
    n_test = int(len(data) * test_fraction)
    return (data.select(np.sort(perm[n_test:])),
            data.select(np.sort(perm[:n_test])))


def split_posonly(data: PosOnlyData, test_fraction: float = 0.2, seed: int = 1):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data))
    n_test = int(len(data) * test_fraction)
    return (data.select(np.sort(perm[n_test:])),
            data.select(np.sort(perm[:n_test])))
