"""Rating-prediction evaluation (RMSE/MAE/NMAE/CBD + cold-start breakdown).

Counterpart of reference ``Eval/Ratings.cs:73-139``. The reference's
per-rating ``Predict`` loop becomes one vectorized ``predict_batch``
call over the whole test set (a gather + fused arithmetic under jit
inside the model).

Models exposing :meth:`pair_scorer` get the device-resident fast path:
the test set is cached on device (first eval pays the upload once),
prediction + metric reduction fuse into ONE jitted call, and only
per-chunk partial sums (~KBs) come back to the host, where they are
accumulated in float64. This is what makes the reference's per-iteration
``--find-iter`` eval loop (RatingPrediction.cs:202-270) cheap: no host
round trip of the test set per evaluation.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from mymedialite_tpu.eval.results import RatingPredictionResults

_CHUNK = 1024  # device partial-sum chunk; host finishes in float64


def _evaluate_indices(recommender, test, idx) -> dict:
    if idx.size == 0:
        return None
    users, items, actual = test.users[idx], test.items[idx], test.values[idx]
    if getattr(recommender, "time_aware", False) and test.times is not None:
        pred = np.asarray(recommender.predict_batch_time(
            users, items, test.times[idx]), dtype=np.float64)
    else:
        pred = np.asarray(recommender.predict_batch(users, items), dtype=np.float64)
    err = pred - actual
    from mymedialite_tpu.eval.measures import compute_cbd
    lo = recommender.min_rating
    hi = recommender.max_rating
    return {
        "RMSE": float(np.sqrt(np.mean(err ** 2))),
        "MAE": float(np.mean(np.abs(err))),
        "NMAE": float(np.mean(np.abs(err)) / (hi - lo)),
        "CBD": float(np.mean(compute_cbd(actual, pred, lo, hi))),
    }


def evaluate_ratings(recommender, test, training=None) -> RatingPredictionResults:
    """Full protocol, incl. cold-start breakdown when ``training`` is given
    (reference Eval/Ratings.cs:82-92: new-user / new-item / new-user-new-item
    subsets by zero training count or out-of-range id)."""
    scorer = None
    if len(test) and not (getattr(recommender, "time_aware", False)
                          and test.times is not None):
        get = getattr(recommender, "pair_scorer", None)
        scorer = get() if get is not None else None
    if scorer is not None:
        return _evaluate_device(recommender, scorer, test, training)
    all_idx = np.arange(len(test))
    results = RatingPredictionResults(_evaluate_indices(recommender, test, all_idx) or {})
    if training is not None:
        tu, ti = test.users, test.items
        cu = training.count_by_user
        ci = training.count_by_item
        new_user = (tu >= training.num_users) | \
            (np.where(tu < training.num_users, cu[np.minimum(tu, training.num_users - 1)], 0) == 0)
        new_item = (ti >= training.num_items) | \
            (np.where(ti < training.num_items, ci[np.minimum(ti, training.num_items - 1)], 0) == 0)
        results.new_user_results = _evaluate_indices(
            recommender, test, all_idx[new_user])
        results.new_item_results = _evaluate_indices(
            recommender, test, all_idx[new_item])
        results.new_user_new_item_results = _evaluate_indices(
            recommender, test, all_idx[new_user & new_item])
    return results


# ---------------------------------------------------------------------------
# device-resident fast path
# ---------------------------------------------------------------------------

def _device_eval_arrays(test):
    """(u, i, v, w) device arrays, pow2-padded (w = 1 real / 0 pad),
    cached on the data object — mutating ops return new objects, so the
    cache can never go stale."""
    cached = test.__dict__.get("_dev_eval")
    if cached is not None:
        return cached
    import jax.numpy as jnp
    n = len(test)
    cap = max(_CHUNK, 1 << max(n - 1, 0).bit_length())
    u = np.pad(test.users.astype(np.int32), (0, cap - n))
    i = np.pad(test.items.astype(np.int32), (0, cap - n))
    v = np.pad(test.values.astype(np.float32), (0, cap - n))
    w = np.zeros(cap, np.float32)
    w[:n] = 1.0
    out = (jnp.asarray(u), jnp.asarray(i), jnp.asarray(v), jnp.asarray(w))
    test.__dict__["_dev_eval"] = out
    return out


def _device_eval_arrays_banked(test):
    """Segmented variant for scorers with a banked user gather
    (ops/gather.py): pairs sorted by user, laid out in [S, SEG_C]
    window segments (pad slots carry w = 0). Metric sums are
    order-invariant, so the re-ordering is observationally free."""
    cached = test.__dict__.get("_dev_eval_banked")
    if cached is not None:
        return cached
    import jax.numpy as jnp

    from mymedialite_tpu.ops import gather as bg
    order = np.argsort(test.users, kind="stable")
    us = test.users[order].astype(np.int32)
    seg_ids, bases, fills = bg.banked_plan(us)
    S = seg_ids.shape[0]
    cap = S * bg.SEG_C
    items_s = test.items[order].astype(np.int32)
    vals_s = test.values[order].astype(np.float32)
    i = np.zeros(cap, np.int32)
    v = np.zeros(cap, np.float32)
    w = np.zeros(cap, np.float32)
    pos = 0
    for s in range(S):
        f = int(fills[s])
        o = s * bg.SEG_C
        i[o:o + f] = items_s[pos:pos + f]
        v[o:o + f] = vals_s[pos:pos + f]
        w[o:o + f] = 1.0
        pos += f
    out = (jnp.asarray(seg_ids.reshape(-1)), jnp.asarray(i),
           jnp.asarray(v), jnp.asarray(w), jnp.asarray(bases))
    test.__dict__["_dev_eval_banked"] = out
    return out


def _device_counts(training):
    cached = training.__dict__.get("_dev_counts")
    if cached is not None:
        return cached
    import jax.numpy as jnp
    out = (jnp.asarray(training.count_by_user.astype(np.int32)),
           jnp.asarray(training.count_by_item.astype(np.int32)))
    training.__dict__["_dev_counts"] = out
    return out


@functools.lru_cache(maxsize=64)
def _metrics_jit(fn, breakdown: bool):
    import jax
    import jax.numpy as jnp

    def go(params, u, i, v, w, lo, hi, cu, ci, U, I):
        pred = fn(params, u, i)
        err = pred - v
        rng = hi - lo
        # CBD (Eval/Ratings.cs:150-162): [0,1]-mapped, pred capped,
        # binomial deviance in log10
        p01 = jnp.clip((pred - lo) / rng, 0.01, 0.99)
        a01 = (v - lo) / rng
        cbd = -(a01 * jnp.log10(p01) + (1.0 - a01) * jnp.log10(1.0 - p01))
        per = jnp.stack([err * err, jnp.abs(err), cbd])        # [3, n]
        if breakdown:
            uc = jnp.clip(u, 0, cu.shape[0] - 1)
            ic = jnp.clip(i, 0, ci.shape[0] - 1)
            nu = (u >= U) | (cu[uc] == 0)
            ni = (i >= I) | (ci[ic] == 0)
            masks = jnp.stack([jnp.ones_like(w),
                               nu.astype(w.dtype),
                               ni.astype(w.dtype),
                               (nu & ni).astype(w.dtype)]) * w  # [4, n]
        else:
            masks = w[None, :]                                  # [1, n]
        k = u.shape[0] // _CHUNK
        per = per.reshape(3, k, _CHUNK)
        masks = masks.reshape(masks.shape[0], k, _CHUNK)
        # HIGHEST: metric sums must not round the errors to TF32
        sums = jnp.einsum("jkc,mkc->mjk", per, masks,
                          precision=jax.lax.Precision.HIGHEST)  # [M, 3, k]
        counts = masks.sum(axis=-1)                             # [M, k]
        return sums, counts

    return jax.jit(go)


def _evaluate_device(recommender, scorer, test, training):
    import jax.numpy as jnp
    fn, params = scorer
    if getattr(fn, "WANTS_UGATHER", False):
        u, i, v, w, bases = _device_eval_arrays_banked(test)
        params = dict(params, _ugather_bases=bases)
    else:
        u, i, v, w = _device_eval_arrays(test)
    lo = float(recommender.min_rating)
    hi = float(recommender.max_rating)
    if training is not None:
        cu, ci = _device_counts(training)
        U, I = training.num_users, training.num_items
    else:
        cu = ci = jnp.zeros(1, jnp.int32)
        U = I = 0
    sums, counts = _metrics_jit(fn, training is not None)(
        params, u, i, v, w, jnp.float32(lo), jnp.float32(hi),
        cu, ci, jnp.int32(U), jnp.int32(I))
    sums = np.asarray(sums, dtype=np.float64)      # [M, 3, k]
    counts = np.asarray(counts, dtype=np.float64)  # [M, k]
    out = []
    for m in range(sums.shape[0]):
        c = counts[m].sum()
        if c == 0:
            out.append(None)
            continue
        se, ae, cb = sums[m].sum(axis=1)
        out.append({
            "RMSE": float(math.sqrt(se / c)),
            "MAE": float(ae / c),
            "NMAE": float(ae / c / (hi - lo)),
            "CBD": float(cb / c),
        })
    results = RatingPredictionResults(out[0] or {})
    if training is not None:
        results.new_user_results = out[1]
        results.new_item_results = out[2]
        results.new_user_new_item_results = out[3]
    return results


def compute_fit(recommender) -> float:
    """RMSE of the recommender on its own training data
    (reference Eval/Ratings.cs ComputeFit)."""
    return _evaluate_indices(
        recommender, recommender.ratings, np.arange(len(recommender.ratings))
    )["RMSE"]
