"""k-nearest-neighbor recommenders (rating + implicit, collaborative +
attribute-based).

JAX counterparts of reference
``RatingPrediction/KNN.cs:47-175`` (+ ``UserKNN.cs:28``, ``ItemKNN.cs:28``,
``UserAttributeKNN.cs``, ``ItemAttributeKNN.cs``) and
``ItemRecommendation/KNN.cs:29-178`` (+ ``UserKNN.cs:30``, ``ItemKNN.cs:31``,
``UserAttributeKNN.cs:26``, ``ItemAttributeKNN.cs:26``).

All correlation matrices come from the matmul kernels in
ops/correlation.py; implicit-KNN scoring is a dense masked-correlation x
incidence matmul over the whole catalog instead of the reference's
per-candidate loops.

Two storage modes, switched automatically on the entity count:

* dense (N <= ``ops.correlation.DENSE_NMAX``): the full [N, N]
  correlation matrix, exact reference semantics;
* top-k (large N): only each row's k best neighbors and their
  correlations, computed by the streaming tiled kernels
  (``binary_correlation_topk`` / ``rating_correlation_topk``) so the
  [N, N] matrix never exists — this is what lets user-user KNN train at
  Netflix shape (480k users) on one chip. Implicit-KNN scoring is exact
  in this mode (it only ever uses the k nearest neighbors); rating-KNN
  prediction considers co-raters within the stored neighbor lists
  (k_store = max(3k, 128) rows), a standard neighborhood truncation of
  the reference's scan over *all* positively correlated co-raters
  (``RatingPrediction/UserKNN.cs:58-93``).
"""

from __future__ import annotations

import enum

import numpy as np
import scipy.sparse as sp

from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu.models.base import (
    IncrementalItemRecommender, IncrementalRatingPredictor,
)
from mymedialite_tpu.models.baselines import UserItemBaseline
from mymedialite_tpu.ops import correlation as corr_ops

INF_K = 2**32 - 1  # reference uint.MaxValue sentinel for K=inf


class BinaryCorrelationType(enum.Enum):
    COSINE = "Cosine"
    JACCARD = "Jaccard"
    CONDITIONAL_PROBABILITY = "ConditionalProbability"
    BIDIRECTIONAL_CONDITIONAL_PROBABILITY = "BidirectionalConditionalProbability"
    COOCCURRENCE = "Cooccurrence"


class RatingCorrelationType(enum.Enum):
    BINARY_COSINE = "BinaryCosine"
    JACCARD = "Jaccard"
    CONDITIONAL_PROBABILITY = "ConditionalProbability"
    BIDIRECTIONAL_CONDITIONAL_PROBABILITY = "BidirectionalConditionalProbability"
    COOCCURRENCE = "Cooccurrence"
    PEARSON = "Pearson"
    RATING_COSINE = "RatingCosine"


_BINARY_KIND = {
    "Cosine": "cosine",
    "BinaryCosine": "cosine",
    "Jaccard": "jaccard",
    "ConditionalProbability": "conditional_probability",
    "BidirectionalConditionalProbability":
        "bidirectional_conditional_probability",
    "Cooccurrence": "cooccurrence",
}


class _EntityView:
    """COO view with (users=entities, items=features) for correlation."""

    def __init__(self, users, items):
        self.users = users
        self.items = items


class _CorrelationStore:
    """Dense [N, N] or per-row top-k correlation storage shared by the
    KNN families (reference SymmetricCorrelationMatrix / the precomputed
    neighbor lists of ItemRecommendation/KNN.cs:104-108)."""

    def _store_dense(self, corr):
        self.corr = corr
        self.nbr_ids = self.nbr_vals = None
        self._sorted_ids = self._sorted_vals = None

    def _store_topk(self, ids, vals):
        self.corr = None
        self.nbr_ids, self.nbr_vals = ids, vals
        # id-sorted copies for O(log k) correlation lookups
        order = np.argsort(ids, axis=1)
        rows = np.arange(ids.shape[0])[:, None]
        self._sorted_ids = ids[rows, order]
        self._sorted_vals = vals[rows, order]

    @property
    def is_topk(self):
        return self.corr is None and self.nbr_ids is not None

    def _lookup_corr(self, row_id, cols):
        """Correlations of ``row_id`` with ``cols`` (0 where not stored)."""
        if not self.is_topk:
            return self.corr[row_id, cols]
        ids = self._sorted_ids[row_id]
        vals = self._sorted_vals[row_id]
        pos = np.clip(np.searchsorted(ids, cols), 0, ids.shape[0] - 1)
        return np.where(ids[pos] == cols, vals[pos], 0.0)

    def get_similarity(self, a, b):
        if not self.is_topk:
            return float(self.corr[a, b])
        return float(self._lookup_corr(a, np.asarray([b]))[0])

    def get_most_similar(self, entity_id, n=10):
        """All entities but self, by descending correlation, first n
        (reference Correlation/Extensions.GetNearestNeighbors :153-166)."""
        if not self.is_topk:
            return corr_ops.nearest_neighbors(self.corr, int(n))[entity_id]
        return self.nbr_ids[entity_id][:int(n)]

    # model-file sections (discriminated: "dense" -> reference-style
    # matrix, "topk N k" -> flat neighbor id/value arrays)
    def _write_corr(self, w):
        if not self.is_topk:
            w._f.write("dense\n")
            w.matrix(self.corr)
        else:
            N, k = self.nbr_ids.shape
            w._f.write(f"topk {N} {k}\n")
            w.int_vector(self.nbr_ids.reshape(-1))
            w.vector(self.nbr_vals.reshape(-1))

    def _read_corr(self, r):
        parts = r._line().split()
        if parts[0] == "dense":
            self._store_dense(r.matrix())
        else:
            N, k = int(parts[1]), int(parts[2])
            ids = r.int_vector().reshape(N, k)
            vals = r.vector().reshape(N, k)
            self._store_topk(ids, vals)


# ---------------------------------------------------------------------------
# implicit-feedback KNN (reference ItemRecommendation/KNN.cs)
# ---------------------------------------------------------------------------

class _ImplicitKNN(IncrementalItemRecommender, _CorrelationStore):
    HYPERPARAMS = {
        "k": int,
        "correlation": BinaryCorrelationType,
        "q": float,
        "weighted": bool,
        "alpha": float,
    }

    ENTITY = "user"      # correlate users or items
    ATTRIBUTES = False   # correlate on attributes instead of feedback

    def __init__(self):
        super().__init__()
        # defaults per reference ItemRecommendation/KNN.cs:32-58
        self.k = 80
        self.q = 1.0
        self.alpha = 0.5
        self.weighted = False
        self.correlation = BinaryCorrelationType.COSINE
        self.corr = None            # [N, N] numpy correlation (dense mode)
        self.nbr_ids = None         # [N, k] ids + values (top-k mode)
        self.nbr_vals = None
        self.neighbors = None       # [N, k] neighbor ids
        self.attributes = None      # InteractionData (entity -> attribute)
        self._Wk_csr = None         # cached sparse weight matrix (top-k)
        self._M_csr = None          # cached sparse incidence (top-k)

    def _correlation_data(self):
        f = self.feedback
        if self.ATTRIBUTES:
            if self.attributes is None:
                raise ValueError(f"{type(self).__name__} needs attribute data")
            n = (f.num_users if self.ENTITY == "user" else f.num_items)
            n_attr = self.attributes.num_items
            return self.attributes, max(n, self.attributes.num_users), n_attr
        if self.ENTITY == "user":
            return (_EntityView(f.users, f.items), f.num_users, f.num_items)
        return (_EntityView(f.items, f.users), f.num_items, f.num_users)

    def train(self):
        data, n, m = self._correlation_data()
        self._Wk_csr = self._M_csr = None
        if n <= corr_ops.DENSE_NMAX:
            self._store_dense(corr_ops.binary_correlation(
                data, n, m, kind=_BINARY_KIND[self.correlation.value],
                alpha=self.alpha, weighted=self.weighted))
        else:
            if self.k == INF_K:
                raise ValueError(
                    f"{type(self).__name__}: k=inf (SumUp) needs the full "
                    f"[N, N] correlation matrix; impossible at N={n} "
                    f"(> DENSE_NMAX={corr_ops.DENSE_NMAX}) — set a finite k")
            self._store_topk(*corr_ops.binary_correlation_topk(
                data, n, m, self.k,
                kind=_BINARY_KIND[self.correlation.value],
                alpha=self.alpha, weighted=self.weighted))
        self._build_neighbors()

    def _build_neighbors(self):
        if self.is_topk:
            self.neighbors = self.nbr_ids
        elif self.k != INF_K:
            self.neighbors = corr_ops.nearest_neighbors(self.corr, self.k)

    def _incidence(self):
        """Binary [num_users, num_items] matrix of the training feedback."""
        f = self.feedback
        return corr_ops.incidence_dense(f, f.num_users, f.num_items)

    def _sparse_mats(self):
        """CSR weight matrix (sign(corr)*|corr|^q at the top-k positions)
        and CSR binary incidence for memory-bounded scoring."""
        if self._Wk_csr is None:
            N, k = self.nbr_ids.shape
            vals = (np.sign(self.nbr_vals) *
                    np.abs(self.nbr_vals) ** self.q).astype(np.float32)
            rows = np.repeat(np.arange(N), k)
            self._Wk_csr = sp.csr_matrix(
                (vals.reshape(-1), (rows, self.nbr_ids.reshape(-1))),
                shape=(N, N))
            f = self.feedback
            M = sp.csr_matrix(
                (np.ones(len(f.users), np.float32), (f.users, f.items)),
                shape=(f.num_users, f.num_items))
            M.data[:] = 1.0       # collapse duplicate events to binary
            self._M_csr = M
            norm = np.asarray(self._Wk_csr.sum(axis=1)).ravel()
            norm[norm == 0] = 1.0
            self._Wk_norm = norm.astype(np.float32)
        return self._Wk_csr, self._M_csr, self._Wk_norm

    def score_catalog(self, users):
        users = np.clip(np.asarray(users, dtype=np.int64), 0,
                        self.feedback.num_users - 1)
        if self.is_topk:
            # sparse top-k mode: same math, [N, N] never materialized
            Wk, M, norm = self._sparse_mats()
            if self.ENTITY == "user":
                scores = np.asarray((Wk[users] @ M).todense()) \
                    / norm[users][:, None]
            else:
                scores = np.asarray((M[users] @ Wk.T).todense()) \
                    / norm[None, :]
            return scores.astype(np.float32)
        M = self._incidence()
        if self.k == INF_K:
            # SumUp path (reference KNN K=inf): unnormalized sum of corr^q
            W = np.sign(self.corr) * np.abs(self.corr) ** self.q
            if self.ENTITY == "user":
                return (W[users] @ M).astype(np.float32)
            return (M[users] @ W.T).astype(np.float32)
        # masked correlations of the k nearest neighbors
        N = self.corr.shape[0]
        Wk = np.zeros_like(self.corr)
        rows = np.repeat(np.arange(N), self.neighbors.shape[1])
        cols = self.neighbors.reshape(-1)
        vals = self.corr[rows, cols]
        Wk[rows, cols] = np.sign(vals) * np.abs(vals) ** self.q
        norm = Wk.sum(axis=1)
        norm[norm == 0] = 1.0
        if self.ENTITY == "user":
            scores = (Wk[users] @ M) / norm[users][:, None]
        else:
            scores = (M[users] @ Wk.T) / norm[None, :]
        return scores.astype(np.float32)

    def predict_batch(self, users, items):
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        out = np.full(users.shape, -np.float32(3.4e38), dtype=np.float32)
        ok = (users >= 0) & (users < self.feedback.num_users) & \
             (items >= 0) & (items < self.feedback.num_items)
        if ok.any():
            uniq_users = np.unique(users[ok])
            scores = self.score_catalog(uniq_users)
            row_of = {int(u): r for r, u in enumerate(uniq_users)}
            rows = np.array([row_of[int(u)] for u in users[ok]])
            out[ok] = scores[rows, items[ok]]
        return out

    def _retrain(self, users, items):
        if self.corr is not None or self.nbr_ids is not None:
            self.train()

    # correlation matrices round-trip in the reference text format
    # (reference ItemRecommendation/KNN.cs:118-160); top-k mode stores
    # the neighbor lists instead
    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w._f.write(f"{self.correlation.value}\n")
            self._write_corr(w)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            name = r._line()
            self.correlation = next(m for m in BinaryCorrelationType
                                    if m.value == name)
            self._read_corr(r)
        self._Wk_csr = self._M_csr = None
        self._build_neighbors()


class _UserSimilarityProvider:
    """Reference IUserSimilarityProvider.cs:7-19."""

    def get_user_similarity(self, user_id1, user_id2):
        return self.get_similarity(user_id1, user_id2)

    def get_most_similar_users(self, user_id, n=10):
        return self.get_most_similar(user_id, n)


class _ItemSimilarityProvider:
    """Reference IItemSimilarityProvider.cs:7-19."""

    def get_item_similarity(self, item_id1, item_id2):
        return self.get_similarity(item_id1, item_id2)

    def get_most_similar_items(self, item_id, n=10):
        return self.get_most_similar(item_id, n)


class UserKNN(_ImplicitKNN, _UserSimilarityProvider):
    """Reference ItemRecommendation/UserKNN.cs:30."""
    ENTITY = "user"


class ItemKNN(_ImplicitKNN, _ItemSimilarityProvider):
    """Reference ItemRecommendation/ItemKNN.cs:31."""
    ENTITY = "item"


class UserAttributeKNN(_ImplicitKNN, _UserSimilarityProvider):
    """Reference ItemRecommendation/UserAttributeKNN.cs:26."""
    ENTITY = "user"
    ATTRIBUTES = True
    REQUIRED_SIDE_INFO = ("user_attributes",)

    @property
    def user_attributes(self):
        return self.attributes

    @user_attributes.setter
    def user_attributes(self, data):
        self.attributes = data


class ItemAttributeKNN(_ImplicitKNN, _ItemSimilarityProvider):
    """Reference ItemRecommendation/ItemAttributeKNN.cs:26."""
    ENTITY = "item"
    ATTRIBUTES = True
    REQUIRED_SIDE_INFO = ("item_attributes",)

    @property
    def item_attributes(self):
        return self.attributes

    @item_attributes.setter
    def item_attributes(self, data):
        self.attributes = data


# ---------------------------------------------------------------------------
# rating-prediction KNN (reference RatingPrediction/KNN.cs)
# ---------------------------------------------------------------------------

class _RatingKNN(IncrementalRatingPredictor, _CorrelationStore):
    HYPERPARAMS = {
        "k": int,
        "correlation": RatingCorrelationType,
        "weighted_binary": bool,
        "alpha": float,
        "reg_u": float,
        "reg_i": float,
        "num_iter": int,
    }

    ENTITY = "user"
    ATTRIBUTES = False

    def __init__(self):
        super().__init__()
        # defaults per reference RatingPrediction/KNN.cs:50 + UserItemBaseline
        self.k = 80
        self.alpha = 0.0
        self.weighted_binary = False
        self.correlation = RatingCorrelationType.PEARSON
        self.baseline = UserItemBaseline()
        self.corr = None
        self.nbr_ids = None
        self.nbr_vals = None
        self.attributes = None

    # baseline hyperparameters pass through (reference KNN.cs:71-78)
    @property
    def reg_u(self):
        return self.baseline.reg_u

    @reg_u.setter
    def reg_u(self, v):
        self.baseline.reg_u = float(v)

    @property
    def reg_i(self):
        return self.baseline.reg_i

    @reg_i.setter
    def reg_i(self, v):
        self.baseline.reg_i = float(v)

    @property
    def num_iter(self):
        return self.baseline.num_iter

    @num_iter.setter
    def num_iter(self, v):
        self.baseline.num_iter = int(v)

    def _k_store(self, n: int) -> int:
        """Stored neighbors per row in top-k mode: enough headroom over the
        prediction-time K that truncation rarely bites."""
        k = 512 if self.k == INF_K else max(128, 3 * self.k)
        return min(n - 1, k)

    def train(self):
        self.baseline.ratings = self.ratings
        self.baseline.train()
        data = self.ratings
        if self.ATTRIBUTES:
            if self.attributes is None:
                raise ValueError(f"{type(self).__name__} needs attribute data")
            n = (data.num_users if self.ENTITY == "user" else data.num_items)
            n = max(n, self.attributes.num_users)
            kind = _BINARY_KIND.get(self.correlation.value, "cosine")
            if n <= corr_ops.DENSE_NMAX:
                self._store_dense(corr_ops.binary_correlation(
                    self.attributes, n, self.attributes.num_items,
                    kind=kind, alpha=self.alpha,
                    weighted=self.weighted_binary))
            else:
                self._store_topk(*corr_ops.binary_correlation_topk(
                    self.attributes, n, self.attributes.num_items,
                    self._k_store(n), kind=kind, alpha=self.alpha,
                    weighted=self.weighted_binary))
        elif self.correlation in (RatingCorrelationType.PEARSON,
                                  RatingCorrelationType.RATING_COSINE):
            kind = ("pearson" if self.correlation ==
                    RatingCorrelationType.PEARSON else "cosine")
            n = data.num_users if self.ENTITY == "user" else data.num_items
            if n <= corr_ops.DENSE_NMAX:
                self._store_dense(corr_ops.rating_correlation(
                    data, entity=self.ENTITY, kind=kind,
                    shrinkage=self.alpha))
            else:
                self._store_topk(*corr_ops.rating_correlation_topk(
                    data, self._k_store(n), entity=self.ENTITY, kind=kind,
                    shrinkage=self.alpha))
        else:
            if self.ENTITY == "user":
                view, n, m = (_EntityView(data.users, data.items),
                              data.num_users, data.num_items)
            else:
                view, n, m = (_EntityView(data.items, data.users),
                              data.num_items, data.num_users)
            kind = _BINARY_KIND[self.correlation.value]
            if n <= corr_ops.DENSE_NMAX:
                self._store_dense(corr_ops.binary_correlation(
                    view, n, m, kind=kind, alpha=self.alpha,
                    weighted=self.weighted_binary))
            else:
                self._store_topk(*corr_ops.binary_correlation_topk(
                    view, n, m, self._k_store(n), kind=kind,
                    alpha=self.alpha, weighted=self.weighted_binary))

    def predict_batch(self, users, items):
        """baseline + sum_w w * (r - baseline) / sum_w over the first K
        positively correlated co-raters, scanned in correlation order
        (reference RatingPrediction/UserKNN.Predict :58-93)."""
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        base = self.baseline.predict_batch(users, items)
        data = self.ratings
        corr_n = (self.nbr_ids if self.is_topk else self.corr).shape[0]
        out = base.astype(np.float64).copy()
        for n_idx, (u, i) in enumerate(zip(users, items)):
            u, i = int(u), int(i)
            if self.ENTITY == "user":
                if u >= corr_n or i >= data.num_items:
                    continue
                co_idx = data.by_item.segment(i)          # ratings of item i
                raters = data.users[co_idx]
                w = self._lookup_corr(u, raters)
            else:
                if i >= corr_n or u >= data.num_users:
                    continue
                co_idx = data.by_user.segment(u)          # ratings by user u
                rated = data.items[co_idx]
                w = self._lookup_corr(i, rated)
            pos = w > 0
            if self.ENTITY == "user":
                pos &= raters != u
            else:
                pos &= rated != i
            if not pos.any():
                continue
            w_pos = w[pos]
            co_pos = co_idx[pos]
            if self.k != INF_K and w_pos.size > self.k:
                top = np.argpartition(-w_pos, self.k - 1)[:self.k]
                w_pos, co_pos = w_pos[top], co_pos[top]
            r = data.values[co_pos]
            if self.ENTITY == "user":
                b = self.baseline.predict_batch(data.users[co_pos],
                                                np.full(co_pos.size, i))
            else:
                b = self.baseline.predict_batch(np.full(co_pos.size, u),
                                                data.items[co_pos])
            out[n_idx] += np.sum(w_pos * (r - b)) / np.sum(w_pos)
        return np.clip(out, self.min_rating, self.max_rating).astype(np.float32)

    def _retrain(self, users, items):
        if self.corr is not None or self.nbr_ids is not None:
            self.train()

    def save_model(self, path):
        self.baseline.ratings = self.ratings
        self.baseline.save_model(path + "-global-effects")
        with ModelWriter(path, type(self).__name__, "3.03") as w:
            w._f.write(f"{self.correlation.value}\n")
            self._write_corr(w)

    def load_model(self, path):
        self.baseline.load_model(path + "-global-effects")
        with ModelReader(path, type(self).__name__) as r:
            name = r._line()
            self.correlation = next(m for m in RatingCorrelationType
                                    if m.value == name)
            self._read_corr(r)


class UserKNNRating(_RatingKNN, _UserSimilarityProvider):
    """Reference RatingPrediction/UserKNN.cs:28."""
    ENTITY = "user"


class ItemKNNRating(_RatingKNN, _ItemSimilarityProvider):
    """Reference RatingPrediction/ItemKNN.cs:28."""
    ENTITY = "item"


class UserAttributeKNNRating(_RatingKNN, _UserSimilarityProvider):
    """Reference RatingPrediction/UserAttributeKNN.cs."""
    ENTITY = "user"
    ATTRIBUTES = True
    REQUIRED_SIDE_INFO = ("user_attributes",)

    def __init__(self):
        super().__init__()
        self.correlation = RatingCorrelationType.BINARY_COSINE

    @property
    def user_attributes(self):
        return self.attributes

    @user_attributes.setter
    def user_attributes(self, data):
        self.attributes = data


class ItemAttributeKNNRating(_RatingKNN, _ItemSimilarityProvider):
    """Reference RatingPrediction/ItemAttributeKNN.cs."""
    ENTITY = "item"
    ATTRIBUTES = True
    REQUIRED_SIDE_INFO = ("item_attributes",)

    def __init__(self):
        super().__init__()
        self.correlation = RatingCorrelationType.BINARY_COSINE

    @property
    def item_attributes(self):
        return self.attributes

    @item_attributes.setter
    def item_attributes(self, data):
        self.attributes = data
