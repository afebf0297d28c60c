"""Trivial / baseline rating predictors.

JAX counterparts of reference ``RatingPrediction/{GlobalAverage,
UserAverage, ItemAverage, EntityAverage, Constant, Random,
UserItemBaseline}.cs``. All support incremental updates.
"""

from __future__ import annotations

import numpy as np

from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu.models.base import IncrementalRatingPredictor, IterativeModel


class GlobalAverage(IncrementalRatingPredictor):
    """Predicts the global rating average (reference GlobalAverage.cs)."""

    def __init__(self):
        super().__init__()
        self.global_average = 0.0

    def train(self):
        self.global_average = self.ratings.average

    def can_predict(self, user_id, item_id):
        return True

    def predict_batch(self, users, items):
        return np.full(np.asarray(users).shape, self.global_average,
                       dtype=np.float32)

    def _retrain(self, users, items):
        self.global_average = self.ratings.average

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_average)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.global_average = r.scalar()


class _EntityAverage(IncrementalRatingPredictor):
    """Per-entity average with global-average fallback
    (reference EntityAverage.cs:25-80)."""

    ENTITY = "user"  # or "item"

    def __init__(self):
        super().__init__()
        self.entity_averages = np.zeros(0, dtype=np.float32)
        self.global_average = 0.0

    def _entity_ids(self):
        return self.ratings.users if self.ENTITY == "user" else self.ratings.items

    def _num_entities(self):
        return self.ratings.num_users if self.ENTITY == "user" \
            else self.ratings.num_items

    def train(self):
        n = self._num_entities()
        ids = self._entity_ids()
        sums = np.zeros(n, dtype=np.float64)
        counts = np.zeros(n, dtype=np.int64)
        np.add.at(sums, ids, self.ratings.values)
        np.add.at(counts, ids, 1)
        self.global_average = self.ratings.average
        self.entity_averages = np.where(
            counts > 0, sums / np.maximum(counts, 1), self.global_average
        ).astype(np.float32)

    def can_predict(self, user_id, item_id):
        return True

    def predict_batch(self, users, items):
        ids = np.asarray(users if self.ENTITY == "user" else items,
                         dtype=np.int64)
        n = self.entity_averages.shape[0]
        out = np.full(ids.shape, self.global_average, dtype=np.float32)
        ok = (ids >= 0) & (ids < n)
        out[ok] = self.entity_averages[ids[ok]]
        return out

    def _retrain(self, users, items):
        self.train()

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_average)
            w.vector(self.entity_averages)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.global_average = r.scalar()
            self.entity_averages = r.vector()


class UserAverage(_EntityAverage):
    """Reference UserAverage.cs."""
    ENTITY = "user"


class ItemAverage(_EntityAverage):
    """Reference ItemAverage.cs."""
    ENTITY = "item"


class Constant(IncrementalRatingPredictor):
    """Always predicts a constant (reference Constant.cs; default 1.0)."""

    HYPERPARAMS = {"constant_rating": float}

    def __init__(self):
        super().__init__()
        self.constant_rating = 1.0

    def train(self):
        pass

    def can_predict(self, user_id, item_id):
        return True

    def predict_batch(self, users, items):
        return np.full(np.asarray(users).shape, self.constant_rating,
                       dtype=np.float32)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class RandomRating(IncrementalRatingPredictor):
    """Uniform random predictions on the rating scale
    (reference RatingPrediction/Random.cs)."""

    def __init__(self):
        super().__init__()
        self.random_seed = 42
        self._rng = np.random.default_rng(42)

    def train(self):
        self._rng = np.random.default_rng(self.random_seed)

    def can_predict(self, user_id, item_id):
        return True

    def predict_batch(self, users, items):
        n = np.asarray(users).shape
        return (self.min_rating + self._rng.random(n) *
                (self.max_rating - self.min_rating)).astype(np.float32)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class UserItemBaseline(IncrementalRatingPredictor, IterativeModel):
    """Koren's mu + b_u + b_i baseline, alternating closed-form updates with
    regularization (reference UserItemBaseline.cs:28-140; RegU=15, RegI=10,
    NumIter=10). Vectorized: each half-step is one bincount-style reduction."""

    HYPERPARAMS = {"reg_u": float, "reg_i": float, "num_iter": int}

    # prediction reads only (b_u, b_i); retrains read per-entity
    # histories through _rated_by_* -> buffered prequential mode works
    SUPPORTS_ONLINE_BUFFER = True
    ONLINE_PREDICT_ROW_LOCAL = True

    def __init__(self):
        super().__init__()
        self.reg_u = 15.0
        self.reg_i = 10.0
        self.num_iter = 10
        self.global_average = 0.0
        self.user_biases = np.zeros(0, dtype=np.float32)
        self.item_biases = np.zeros(0, dtype=np.float32)

    def train(self):
        self.global_average = self.ratings.average
        self.user_biases = np.zeros(self.ratings.num_users, dtype=np.float32)
        self.item_biases = np.zeros(self.ratings.num_items, dtype=np.float32)
        for _ in range(self.num_iter):
            self.iterate()

    def iterate(self):
        # order matters: items first, then users (reference Iterate :98-102)
        self._optimize(self.item_biases, self.ratings.items, self.ratings.users,
                       self.user_biases, self.reg_i)
        self._optimize(self.user_biases, self.ratings.users, self.ratings.items,
                       self.item_biases, self.reg_u)

    def _optimize(self, biases, ids, other_ids, other_biases, reg):
        n = biases.shape[0]
        resid = self.ratings.values - self.global_average - other_biases[other_ids]
        sums = np.zeros(n, dtype=np.float64)
        counts = np.zeros(n, dtype=np.int64)
        np.add.at(sums, ids, resid)
        np.add.at(counts, ids, 1)
        biases[:] = np.where(counts > 0, sums / (reg + counts), 0.0)

    def can_predict(self, user_id, item_id):
        return True

    def predict_batch(self, users, items):
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        bu = np.zeros(users.shape, dtype=np.float32)
        bi = np.zeros(items.shape, dtype=np.float32)
        ok_u = (users >= 0) & (users < self.user_biases.shape[0])
        ok_i = (items >= 0) & (items < self.item_biases.shape[0])
        bu[ok_u] = self.user_biases[users[ok_u]]
        bi[ok_i] = self.item_biases[items[ok_i]]
        return np.clip(self.global_average + bu + bi,
                       self.min_rating, self.max_rating).astype(np.float32)

    def score_catalog(self, users):
        users = np.clip(np.asarray(users, dtype=np.int64), 0,
                        max(self.user_biases.shape[0] - 1, 0))
        raw = (self.global_average + self.user_biases[users][:, None]
               + self.item_biases[None, :])
        return np.clip(raw, self.min_rating, self.max_rating).astype(np.float32)

    def retrain_user(self, user_id):
        """Touched-row bias refresh (reference UserItemBaseline.cs:151-160
        — note the reference folds the PREVIOUS bias value into the
        numerator sum before dividing; mirrored exactly)."""
        if not self.update_users or not (
                0 <= user_id < self.user_biases.shape[0]):
            return
        items, vals = self._rated_by_user(user_id)
        if items.size == 0:
            return
        ok = (items >= 0) & (items < self.item_biases.shape[0])
        bi = np.where(ok, self.item_biases[
            np.clip(items, 0, max(self.item_biases.shape[0] - 1, 0))], 0.0)
        s = float(self.user_biases[user_id]) + float(
            np.sum(vals - self.global_average - bi))
        self.user_biases[user_id] = s / (self.reg_u + items.size)

    def retrain_item(self, item_id):
        """Reference UserItemBaseline.cs:163-172."""
        if not self.update_items or not (
                0 <= item_id < self.item_biases.shape[0]):
            return
        users, vals = self._rated_by_item(item_id)
        if users.size == 0:
            return
        ok = (users >= 0) & (users < self.user_biases.shape[0])
        bu = np.where(ok, self.user_biases[
            np.clip(users, 0, max(self.user_biases.shape[0] - 1, 0))], 0.0)
        s = float(self.item_biases[item_id]) + float(
            np.sum(vals - self.global_average - bu))
        self.item_biases[item_id] = s / (self.reg_i + users.size)

    def _grow(self, num_users, num_items):
        # zero-extend (reference AddUser/AddItem grow the bias arrays)
        if num_users > self.user_biases.shape[0]:
            nb = np.zeros(num_users, np.float32)
            nb[:self.user_biases.shape[0]] = self.user_biases
            self.user_biases = nb
        if num_items > self.item_biases.shape[0]:
            nb = np.zeros(num_items, np.float32)
            nb[:self.item_biases.shape[0]] = self.item_biases
            self.item_biases = nb

    def _retrain(self, users, items):
        # touched rows only, like the reference's AddRatings ->
        # RetrainUser/RetrainItem (a full alternating refresh here made
        # prequential eval O(n) PER EVENT)
        if self.user_biases.size == 0:
            return
        self._grow(max((int(u) for u in users), default=-1) + 1,
                   max((int(i) for i in items), default=-1) + 1)
        # users first, then items (reference UserItemBaseline.cs:175-182)
        for u in users:
            self.retrain_user(int(u))
        for i in items:
            self.retrain_item(int(i))

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_average)
            w.vector(self.user_biases)
            w.vector(self.item_biases)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.global_average = r.scalar()
            self.user_biases = r.vector()
            self.item_biases = r.vector()
        self.num_users_trained = self.user_biases.shape[0]
        self.num_items_trained = self.item_biases.shape[0]
