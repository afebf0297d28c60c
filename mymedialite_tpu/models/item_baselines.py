"""Trivial / popularity item recommenders.

JAX counterparts of reference ``ItemRecommendation/{MostPopular,
MostPopularByAttributes, Zero, Random, BigramRules}.cs``.
"""

from __future__ import annotations

import numpy as np

from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu.models.base import (
    IncrementalItemRecommender, ItemRecommender,
)


class MostPopular(IncrementalItemRecommender):
    """Popularity count, optionally per-user-deduplicated
    (reference MostPopular.cs:38-120)."""

    HYPERPARAMS = {"by_user": bool}

    def __init__(self):
        super().__init__()
        self.by_user = False
        self.view_count = np.zeros(0, dtype=np.int64)

    def train(self):
        f = self.feedback
        if self.by_user:
            self.view_count = f.dedup_count_by_item.copy()
        else:
            counts = np.zeros(f.num_items, dtype=np.int64)
            np.add.at(counts, f.items, 1)
            self.view_count = counts

    def _norm(self):
        # reference Predict: normalize by num users (by_user) or event count
        return (self.feedback.num_users if self.by_user
                else max(len(self.feedback), 1))

    def predict_batch(self, users, items):
        items = np.asarray(items, dtype=np.int64)
        out = np.full(items.shape, -np.float32(3.4e38), dtype=np.float32)
        ok = (items >= 0) & (items < self.view_count.shape[0])
        out[ok] = self.view_count[items[ok]] / self._norm()
        return out

    def score_catalog(self, users):
        row = (self.view_count / self._norm()).astype(np.float32)
        return np.tile(row, (np.asarray(users).size, 1))

    def _retrain(self, users, items):
        self.train()

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.int_vector(self.view_count)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.view_count = r.int_vector().astype(np.int64)
        self.num_items_trained = self.view_count.shape[0]


class Zero(ItemRecommender):
    """Always scores 0 (reference Zero.cs:24)."""

    def train(self):
        pass

    def predict_batch(self, users, items):
        return np.zeros(np.asarray(users).shape, dtype=np.float32)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class RandomItem(ItemRecommender):
    """Uniform random scores (reference ItemRecommendation/Random.cs:24)."""

    def __init__(self):
        super().__init__()
        self.random_seed = 42
        self._rng = np.random.default_rng(42)

    def train(self):
        self._rng = np.random.default_rng(self.random_seed)

    def predict_batch(self, users, items):
        return self._rng.random(np.asarray(users).shape).astype(np.float32)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class MostPopularByAttributes(ItemRecommender):
    REQUIRED_SIDE_INFO = ("item_attributes",)
    """Popularity within item-attribute groups
    (reference MostPopularByAttributes.cs:47-120): score =
    (1 + sum of the user's per-attribute counts over the item's
    attributes) * (popularity + 1) / (|attrs(item)| + 1)."""

    def __init__(self):
        super().__init__()
        self.item_attributes = None  # InteractionData: item -> attribute
        self._mp = MostPopular()
        self._attr_count = None      # [U, n_attr]
        self._A = None               # [I, n_attr] binary

    def train(self):
        if self.item_attributes is None:
            raise ValueError("MostPopularByAttributes needs item attributes")
        f = self.feedback
        self._mp.feedback = f
        self._mp.train()
        n_attr = self.item_attributes.num_items
        I = max(f.num_items, self.item_attributes.num_users)
        self.num_items_trained = I
        A = np.zeros((I, n_attr), dtype=np.float32)
        A[self.item_attributes.users, self.item_attributes.items] = 1.0
        self._A = A
        M = np.zeros((f.num_users, I), dtype=np.float32)
        M[f.users, f.items] += 1.0  # event counts (not deduped)
        # reference counts one increment per feedback EVENT per attribute
        cnt = np.zeros((f.num_users, I), dtype=np.float32)
        np.add.at(cnt, (f.users, f.items), 1.0)
        self._attr_count = cnt @ A   # [U, n_attr]

    def score_catalog(self, users):
        users = np.clip(np.asarray(users, dtype=np.int64), 0,
                        self._attr_count.shape[0] - 1)
        mp_row = (self._mp.view_count / self._mp._norm()).astype(np.float32)
        attr_term = 1.0 + self._attr_count[users] @ self._A.T  # [B, I]
        denom = self._A.sum(axis=1) + 1.0
        return (attr_term * (mp_row + 1.0)[None, :] /
                denom[None, :]).astype(np.float32)

    def predict_batch(self, users, items):
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        out = np.full(users.shape, -np.float32(3.4e38), dtype=np.float32)
        ok = (users >= 0) & (users < self.feedback.num_users) & \
             (items >= 0) & (items < self.num_items_trained)
        if ok.any():
            uniq = np.unique(users[ok])
            scores = self.score_catalog(uniq)
            row_of = {int(u): r for r, u in enumerate(uniq)}
            rows = np.array([row_of[int(u)] for u in users[ok]])
            out[ok] = scores[rows, items[ok]]
        return out

    def save_model(self, path):
        raise NotImplementedError  # same as reference

    def load_model(self, path):
        raise NotImplementedError


class BigramRules(ItemRecommender):
    """Item->item association rules from co-occurring events
    (reference BigramRules.cs:27-100): score(u,i) =
    sum_{j in I_u, j != i} support * confidence
    = sum_j C[j,i]^2 / (|U_j| * N)."""

    def __init__(self):
        super().__init__()
        self._R = None

    def train(self):
        import jax.numpy as jnp
        from mymedialite_tpu.ops.correlation import incidence_dense
        f = self.feedback
        M = incidence_dense(f, f.num_users, f.num_items)  # binary (dedup)
        C = np.array(jnp.dot(jnp.asarray(M).T, jnp.asarray(M),
                             preferred_element_type=jnp.float32))
        np.fill_diagonal(C, 0.0)
        cnt = np.maximum(M.sum(axis=0), 1.0)  # |U_j|
        N = max(len(f), 1)
        self._R = (C * C / (cnt[:, None] * N)).astype(np.float32)
        self._M = M

    def score_catalog(self, users):
        users = np.clip(np.asarray(users, dtype=np.int64), 0,
                        self._M.shape[0] - 1)
        return (self._M[users] @ self._R).astype(np.float32)

    def predict_batch(self, users, items):
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        out = np.full(users.shape, -np.float32(3.4e38), dtype=np.float32)
        ok = (items >= 0) & (items < self._R.shape[0]) & (users >= 0) & \
             (users < self._M.shape[0])
        if ok.any():
            uniq = np.unique(users[ok])
            scores = self.score_catalog(uniq)
            row_of = {int(u): r for r, u in enumerate(uniq)}
            rows = np.array([row_of[int(u)] for u in users[ok]])
            out[ok] = scores[rows, items[ok]]
        return out

    def save_model(self, path):
        from mymedialite_tpu.io.model_io import ModelWriter
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.matrix(self._R)

    def load_model(self, path):
        from mymedialite_tpu.io.model_io import ModelReader
        with ModelReader(path, type(self).__name__) as r:
            self._R = r.matrix()
        self.num_items_trained = self._R.shape[0]
        if self.feedback is not None:
            from mymedialite_tpu.ops.correlation import incidence_dense
            f = self.feedback
            self._M = incidence_dense(f, f.num_users, f.num_items)
