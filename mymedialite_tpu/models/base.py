"""Recommender base classes — the API surface of the framework.

JAX counterpart of reference ``IRecommender.cs:33-82``,
``Recommender.cs:28-119``, ``RatingPrediction/RatingPredictor.cs:26-52``,
``RatingPrediction/IncrementalRatingPredictor.cs:24-108``,
``ItemRecommendation/ItemRecommender.cs:42-55``,
``ItemRecommendation/IncrementalItemRecommender.cs:29-102``,
``IIterativeModel.cs``, ``IFoldInRatingPredictor.cs``,
``IFoldInItemRecommender.cs``.

Design difference from the reference: the *vectorized* entry points
(``predict_batch`` over rating pairs, ``score_catalog`` over the full
item catalog) are the primitives, and scalar ``predict`` / per-user
``recommend`` are conveniences on top. The reference's per-candidate
``Predict`` loop + IntervalHeap top-N (``Recommender.cs:52-103``) becomes
one batched score computation + ``top-K`` on device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from mymedialite_tpu.utils.params import echo


import functools


@functools.lru_cache(maxsize=128)
def _jit_scorer(fn):
    import jax
    return jax.jit(fn)


class Recommender:
    """Root of the recommender hierarchy (reference IRecommender.cs:33-82)."""

    HYPERPARAMS: dict = {}

    # --- core prediction API ---

    def predict(self, user_id: int, item_id: int) -> float:
        return float(self.predict_batch(np.array([user_id], dtype=np.int32),
                                        np.array([item_id], dtype=np.int32))[0])

    def predict_batch(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        """Vectorized point predictions; the primitive subclasses implement."""
        raise NotImplementedError

    def can_predict(self, user_id: int, item_id: int) -> bool:
        """Reference Recommender.CanPredict (default: ids in range)."""
        return (0 <= user_id < self.num_users_trained
                and 0 <= item_id < self.num_items_trained)

    # Catalog size the model was trained with; subclasses set in train().
    num_users_trained: int = 0
    num_items_trained: int = 0

    def score_catalog(self, users: np.ndarray) -> np.ndarray:
        """[len(users), num_items] score matrix. Default: tiled predict_batch;
        factor models override with one [B,f]x[f,N] matmul."""
        users = np.asarray(users, dtype=np.int32)
        n_items = self.num_items_trained
        out = np.empty((users.size, n_items), dtype=np.float32)
        all_items = np.arange(n_items, dtype=np.int32)
        for r, u in enumerate(users):
            out[r] = self.predict_batch(np.full(n_items, u, dtype=np.int32),
                                        all_items)
        return out

    def catalog_scorer(self):
        """Optional pure catalog scorer: ``(fn, params)`` where
        ``fn(params, users_int32) -> [B, num_items_trained]`` device
        scores. ``fn`` must be a *module-level* function (stable identity
        so jit caches compile once) with all state in ``params`` (passed
        as arguments, never closed over — closures inline as HLO
        constants, which bloats the program for big tables).
        None = host scoring only."""
        return None

    def pair_scorer(self):
        """Optional pure pairwise scorer: ``(fn, params)`` where
        ``fn(params, users_i32, items_i32) -> [n]`` device predictions
        (same contract as :meth:`catalog_scorer`: module-level ``fn``,
        all state in ``params``). Lets the evaluator fuse prediction and
        metric reduction into one jitted call with the test set resident
        on device — the per-iteration eval of the reference's
        ``--find-iter`` loop (RatingPrediction.cs:202-270) without a
        host<->device round trip per call. None = host scoring only."""
        return None

    def score_catalog_device(self, users: np.ndarray):
        """score_catalog as a device (jnp) array, computed in one jitted
        call when the model provides a catalog_scorer (instead of one
        eager dispatch per op)."""
        import jax.numpy as jnp
        scorer = self.catalog_scorer()
        if scorer is None:
            return jnp.asarray(self.score_catalog(users))
        fn, params = scorer
        return _jit_scorer(fn)(params, jnp.asarray(users, dtype=jnp.int32))

    def recommend(self, user_id: int, n: int = -1,
                  candidates: Optional[Sequence[int]] = None,
                  ignore_items: Optional[Sequence[int]] = None):
        """Top-N recommendation (reference Recommender.Recommend,
        Recommender.cs:52-103). Returns a list of (item_id, score),
        sorted by descending score."""
        scores = self.score_catalog(np.array([user_id], dtype=np.int32))[0]
        mask = np.zeros(scores.size, dtype=bool)
        if candidates is not None:
            cand = np.asarray(list(candidates), dtype=np.int64)
            cand = cand[(cand >= 0) & (cand < scores.size)]
            mask[:] = True
            mask[cand] = False
        if ignore_items is not None:
            ign = np.asarray(list(ignore_items), dtype=np.int64)
            ign = ign[(ign >= 0) & (ign < scores.size)]
            mask[ign] = True
        scores = np.where(mask, -np.inf, scores)
        if n < 0:
            order = np.argsort(-scores, kind="stable")
        else:
            n = min(n, scores.size)
            top = np.argpartition(-scores, n - 1)[:n] if n < scores.size \
                else np.arange(scores.size)
            order = top[np.argsort(-scores[top], kind="stable")]
        return [(int(i), float(scores[i])) for i in order
                if np.isfinite(scores[i])]

    # --- lifecycle ---

    def train(self) -> None:
        raise NotImplementedError

    def save_model(self, path: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not support saving")

    def load_model(self, path: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not support loading")

    def __str__(self) -> str:
        return echo(self)


class RatingPredictor(Recommender):
    """Explicit-feedback recommender (reference RatingPredictor.cs:26-52)."""

    def __init__(self):
        self._ratings = None
        self.min_rating = 0.0
        self.max_rating = 5.0

    @property
    def ratings(self):
        return self._ratings

    @ratings.setter
    def ratings(self, data):
        # wires MaxUserID/MaxItemID/scale, reference RatingPredictor.cs:39-49
        self._ratings = data
        if data is not None:
            self.min_rating = data.scale.min
            self.max_rating = data.scale.max
            self.num_users_trained = data.num_users
            self.num_items_trained = data.num_items


class IncrementalRatingPredictor(RatingPredictor):
    """Online updates for explicit feedback
    (reference IncrementalRatingPredictor.cs:24-108)."""

    # Models whose _retrain reads per-entity histories through
    # _rated_by_user/_rated_by_item (rather than self.ratings directly)
    # can run prequential eval in buffered mode: events append to O(1)
    # host buffers and fold into the immutable dataset once at the end,
    # instead of rebuilding the COO arrays + CSR sort per event.
    SUPPORTS_ONLINE_BUFFER = False
    # Prediction for (u, i) reads only u's and i's rows (true for the MF
    # family) — lets the online evaluator batch predictions between
    # touched-row collisions without changing the protocol's results.
    ONLINE_PREDICT_ROW_LOCAL = False

    def __init__(self):
        super().__init__()
        self.update_users = True
        self.update_items = True
        self._online_active = False

    def begin_online_updates(self) -> bool:
        """Enter buffered prequential-update mode (eval/online.py).
        Returns False (and stays in the per-event path) for models whose
        _retrain reads the full dataset."""
        if not self.SUPPORTS_ONLINE_BUFFER:
            return False
        self._online_user_hist = {}
        self._online_item_hist = {}
        self._online_events = ([], [], [])
        self._online_active = True
        return True

    def end_online_updates(self) -> None:
        """Fold the buffered events into the dataset (one array rebuild)."""
        if not self._online_active:
            return
        self._online_active = False
        ue, ie, ve = self._online_events
        if ue:
            self.ratings = self.ratings.add(ue, ie, ve)
        self._online_user_hist = None
        self._online_item_hist = None
        self._online_events = None
        self._online_flush()

    def _online_flush(self) -> None:
        """Hook: invalidate per-model epoch caches after events fold in."""

    def _rated_by_user(self, u: int):
        """(items, values) rated by u — base dataset plus any buffered
        online events (reference DataSet.ByUser view)."""
        data = self.ratings
        if 0 <= u < data.num_users:
            idx = data.by_user.segment(u)
            items, vals = data.items[idx], data.values[idx]
        else:
            items = np.array([], dtype=np.int32)
            vals = np.array([], dtype=np.float32)
        if self._online_active:
            hist = self._online_user_hist.get(u)
            if hist:
                items = np.concatenate(
                    [items, np.asarray(hist[0], dtype=np.int32)])
                vals = np.concatenate(
                    [vals, np.asarray(hist[1], dtype=np.float32)])
        return items, vals

    def _rated_by_item(self, i: int):
        """(users, values) who rated i — base dataset plus buffered events."""
        data = self.ratings
        if 0 <= i < data.num_items:
            idx = data.by_item.segment(i)
            users, vals = data.users[idx], data.values[idx]
        else:
            users = np.array([], dtype=np.int32)
            vals = np.array([], dtype=np.float32)
        if self._online_active:
            hist = self._online_item_hist.get(i)
            if hist:
                users = np.concatenate(
                    [users, np.asarray(hist[0], dtype=np.int32)])
                vals = np.concatenate(
                    [vals, np.asarray(hist[1], dtype=np.float32)])
        return users, vals

    def add_ratings(self, users, items, values) -> None:
        if self._online_active:
            ue, ie, ve = self._online_events
            for u, i, v in zip(users, items, values):
                u, i, v = int(u), int(i), float(v)
                ue.append(u)
                ie.append(i)
                ve.append(v)
                self._online_user_hist.setdefault(u, ([], []))
                self._online_user_hist[u][0].append(i)
                self._online_user_hist[u][1].append(v)
                self._online_item_hist.setdefault(i, ([], []))
                self._online_item_hist[i][0].append(u)
                self._online_item_hist[i][1].append(v)
            self._retrain(users, items)
            return
        self.ratings = self.ratings.add(users, items, values)
        self._retrain(users, items)

    def update_ratings(self, users, items, values) -> None:
        self.ratings = self.ratings.update(users, items, values)
        self._retrain(users, items)

    def remove_ratings(self, users, items) -> None:
        data = self.ratings
        keep = np.ones(len(data), dtype=bool)
        for u, i in zip(users, items):
            seg = data.by_user.segment(u)
            keep[seg[data.items[seg] == i]] = False
        self.ratings = data.select(np.nonzero(keep)[0])
        self._retrain(users, items)

    def add_user(self, user_id: int) -> None:
        self.num_users_trained = max(self.num_users_trained, user_id + 1)

    def add_item(self, item_id: int) -> None:
        self.num_items_trained = max(self.num_items_trained, item_id + 1)

    def remove_user(self, user_id: int) -> None:
        self.ratings = self.ratings.remove_user(user_id)
        self._retrain([user_id], [])

    def remove_item(self, item_id: int) -> None:
        self.ratings = self.ratings.remove_item(item_id)
        self._retrain([], [item_id])

    def _retrain(self, users, items) -> None:
        """Hook: refresh per-user/per-item state after an incremental change
        (reference RetrainUser/RetrainItem semantics)."""


class ItemRecommender(Recommender):
    """Implicit-feedback recommender (reference ItemRecommender.cs:42-55)."""

    def __init__(self):
        self._feedback = None

    @property
    def feedback(self):
        return self._feedback

    @feedback.setter
    def feedback(self, data):
        self._feedback = data
        if data is not None:
            self.num_users_trained = data.num_users
            self.num_items_trained = data.num_items


class IncrementalItemRecommender(ItemRecommender):
    """Online updates for implicit feedback
    (reference IncrementalItemRecommender.cs:29-102)."""

    # reference IncrementalItemRecommender.cs:32-35: C# auto-property
    # defaults (false); subclasses override in their ctors (BPRMF.cs:116,
    # KNN.cs:73, MostPopular.cs:52)
    update_users = False
    update_items = False

    def add_feedback(self, users, items) -> None:
        self.feedback = self.feedback.add(users, items)
        self._retrain(users, items)

    def remove_feedback(self, users, items) -> None:
        self.feedback = self.feedback.remove(users, items)
        self._retrain(users, items)

    def remove_user(self, user_id: int) -> None:
        self.feedback = self.feedback.remove_user(user_id)
        self._retrain([user_id], [])

    def remove_item(self, item_id: int) -> None:
        self.feedback = self.feedback.remove_item(item_id)
        self._retrain([], [item_id])

    def _retrain(self, users, items) -> None:
        pass


class IterativeModel:
    """Mixin: models trained by repeated ``iterate()`` calls — drives the
    CLI's --find-iter convergence loop (reference IIterativeModel.cs)."""

    num_iter: int = 30

    def iterate(self) -> None:
        raise NotImplementedError

    def compute_objective(self) -> float:
        """Training objective (for bold-driver LR / convergence logging)."""
        return float("nan")


class FoldInRatingPredictor:
    """Reference IFoldInRatingPredictor: score candidate items for an unseen
    user described by (item_id, rating) pairs, without mutating the model."""

    def score_items_foldin(self, rated_items, candidates):
        raise NotImplementedError


class FoldInItemRecommender:
    """Reference IFoldInItemRecommender: same, with an accessed-items list."""

    def score_items_foldin(self, accessed_items, candidates):
        raise NotImplementedError
