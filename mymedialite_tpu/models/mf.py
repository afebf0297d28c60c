"""Matrix factorization rating predictors (plain + biased).

JAX counterparts of reference
``RatingPrediction/MatrixFactorization.cs:50`` (plain MF, SGD on RMSE)
and ``RatingPrediction/BiasedMatrixFactorization.cs:77`` (the flagship:
biases + sigmoid-squashed prediction, selectable RMSE/MAE/LogisticLoss,
frequency regularization, bold-driver learn-rate adaptation).

The reference's sequential per-rating SGD and its DSGD multicore path
both become jitted blocked minibatch-SGD epochs (ops/sgd.py,
``sgd_epoch_blocked``): biases live as fused extra columns of the factor
tables ([factors | b_u | 1] x [factors | 1 | b_i]), and the user table
is processed in slabs of contiguous user-id groups. The reference's
``max_threads`` / ``naive_parallelization`` knobs are accepted for CLI
compatibility;
parallelism comes from XLA + (multi-chip) sharding.
"""

from __future__ import annotations

import enum
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu.models.base import (
    FoldInRatingPredictor, IncrementalRatingPredictor, IterativeModel,
)
from mymedialite_tpu.ops import sgd


class OptimizationTarget(enum.Enum):
    """Reference OptimizationTarget enum (RMSE / MAE / LogisticLoss)."""
    RMSE = "RMSE"
    MAE = "MAE"
    LOGISTIC_LOSS = "LogisticLoss"


_LOSS_ID = {
    OptimizationTarget.RMSE: sgd.LOSS_RMSE,
    OptimizationTarget.MAE: sgd.LOSS_MAE,
    OptimizationTarget.LOGISTIC_LOSS: sgd.LOSS_LOGISTIC,
}


# module-level pure catalog scorers (stable identity -> one jit compile;
# see Recommender.catalog_scorer)

def _mf_catalog_raw(params, users):
    # default matmul precision (TF32 where the GPU has it): ranking
    # metrics agree with a float32 reference within a tolerance
    W, H = params["W"], params["H"]
    u = jnp.clip(users, 0, W.shape[0] - 1)
    return params["global_bias"] + W[u] @ H.T


def _mf_catalog_clip(params, users):
    return jnp.clip(_mf_catalog_raw(params, users),
                    params["min_rating"], params["max_rating"])


def _mf_catalog_sigmoid(params, users):
    rng = jnp.maximum(params["max_rating"] - params["min_rating"], 1e-9)
    return params["min_rating"] + \
        jax.nn.sigmoid(_mf_catalog_raw(params, users)) * rng


class MatrixFactorization(IncrementalRatingPredictor, IterativeModel,
                          FoldInRatingPredictor):
    """Plain MF: prediction = global_bias + <w_u, h_i>, clamped to the
    rating scale (reference MatrixFactorization.cs:50-217)."""

    HYPERPARAMS = {
        "num_factors": int,
        "regularization": float,
        "learn_rate": float,
        "learn_rate_decay": float,
        "num_iter": int,
    }
    EXTRA_PARAMS = {
        "init_mean": float,
        "init_stdev": float,
        "batch_size": int,
        "group_users": int,
    }

    BIASED = False
    # _retrain reads histories via _rated_by_user/_rated_by_item and
    # prediction touches only rows (u, i): buffered prequential eval and
    # chunked predict batching are exact (eval/online.py)
    SUPPORTS_ONLINE_BUFFER = True
    ONLINE_PREDICT_ROW_LOCAL = True

    def __init__(self):
        super().__init__()
        # defaults per reference MatrixFactorization.cs:87-95
        self.num_factors = 10
        self.regularization = 0.015
        self.learn_rate = 0.01
        self.learn_rate_decay = 1.0
        self.num_iter = 30
        self.init_mean = 0.0
        self.init_stdev = 0.1
        self.batch_size = 131_072   # SGD minibatch size
        self.group_users = 16_384   # user-slab rows
        self.random_seed = 42

        self.W_ext = None           # [U_pad, f+2] fused user table
        self.H_ext = None           # [I, f+2] fused item table
        self.global_bias = 0.0
        self.current_learnrate = None
        self._blocked = None
        self._bmeta = None
        self._flat_cache = None
        self._key = None

    # --- hyperparameter plumbing ---

    @property
    def reg_u(self):
        return getattr(self, "_reg_u", self.regularization)

    @reg_u.setter
    def reg_u(self, v):
        self._reg_u = float(v)

    @property
    def reg_i(self):
        return getattr(self, "_reg_i", self.regularization)

    @reg_i.setter
    def reg_i(self, v):
        self._reg_i = float(v)

    @property
    def loss_id(self):
        return sgd.LOSS_RMSE

    @property
    def frequency_regularization(self):
        return False

    def _hp(self):
        rng = max(self.max_rating - self.min_rating, 1e-9)
        return dict(global_bias=jnp.float32(self.global_bias),
                    min_rating=jnp.float32(self.min_rating),
                    rating_range=jnp.float32(rng))

    # --- model init / training ---

    def _init_global_bias(self):
        return float(self.ratings.average)

    def init_model(self):
        """Factor allocation + N(mean, stdev) init; zero rows for entities
        without training examples (reference MatrixFactorization.cs:99-116)."""
        data = self.ratings
        key = jax.random.PRNGKey(self.random_seed)
        self._key, ku, ki = jax.random.split(key, 3)
        self._key_pool = None
        U, I, f = data.num_users, data.num_items, self.num_factors
        wu = self.init_mean + self.init_stdev * np.array(
            jax.random.normal(ku, (U, f), dtype=jnp.float32))
        hi = self.init_mean + self.init_stdev * np.array(
            jax.random.normal(ki, (I, f), dtype=jnp.float32))
        wu[data.count_by_user == 0] = 0.0
        hi[data.count_by_item == 0] = 0.0
        self.W_ext, self.H_ext = sgd.extend_tables(
            wu, hi, group_users=self.group_users)
        self.global_bias = self._init_global_bias()
        self.current_learnrate = self.learn_rate
        self._prepare_epoch_data()

    def _prepare_epoch_data(self):
        data = self.ratings
        self._blocked, self._bmeta = sgd.prepare_blocked_data(
            data.users, data.items, data.values, data.num_users,
            self.batch_size, self.group_users, shuffle_seed=self.random_seed)
        if self.frequency_regularization:
            U_pad = self.W_ext.shape[0] if self.W_ext is not None else \
                self._bmeta["ngroups"] * self._bmeta["group_users"]
            cu = np.zeros(U_pad, np.float32)
            cu[:data.num_users] = data.count_by_user
            ci = np.maximum(data.count_by_item, 1).astype(np.float32)
            self._freq = (jnp.asarray(1.0 / np.sqrt(np.maximum(cu, 1.0))),
                          jnp.asarray(1.0 / np.sqrt(ci)))
        else:
            self._freq = (jnp.zeros(0), jnp.zeros(0))
        self._flat_cache = None

    def _flat_data(self):
        """Flat epoch-data view, used by the objective computation."""
        if self._flat_cache is None:
            data = self.ratings
            self._flat_cache = sgd.prepare_epoch_data(
                data.users, data.items, data.values, self.batch_size,
                shuffle_seed=None, num_users=data.num_users,
                num_items=data.num_items)
            self._counts = dict(
                count_user=jnp.asarray(data.count_by_user),
                count_item=jnp.asarray(data.count_by_item))
        return self._flat_cache

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def _ensure_epoch_ready(self):
        """Lazily rebuild the blocked epoch data when missing — e.g. after
        ``load_model`` — so ``iterate()``/``compute_objective()`` keep
        working without a fresh ``train()`` (reference
        MatrixFactorization.cs Train/Iterate split: LoadModel then Iterate
        continues training)."""
        if self._blocked is None:
            if self.ratings is None:
                raise RuntimeError(
                    f"{type(self).__name__}: no ratings set; assign "
                    ".ratings before iterating a loaded model")
            self._prepare_epoch_data()
        # grow the loaded tables to cover the epoch's padded id space
        need_u = self._bmeta["ngroups"] * self._bmeta["group_users"]
        if self.W_ext.shape[0] < need_u:
            fe = self.W_ext.shape[1]
            pad = np.zeros((need_u - self.W_ext.shape[0], fe), np.float32)
            pad[:, fe - 1] = 1.0
            self.W_ext = jnp.concatenate([self.W_ext, jnp.asarray(pad)])
        if self.H_ext.shape[0] < self.ratings.num_items:
            fe = self.H_ext.shape[1]
            pad = np.zeros((self.ratings.num_items - self.H_ext.shape[0], fe),
                           np.float32)
            pad[:, fe - 2] = 1.0
            self.H_ext = jnp.concatenate([self.H_ext, jnp.asarray(pad)])

    def iterate(self, update_user: bool = True, update_item: bool = True):
        self._ensure_epoch_ready()
        self._key, sub = jax.random.split(self._key)
        rates = sgd.column_rates(
            self.num_factors, self.current_learnrate, self.reg_u, self.reg_i,
            getattr(self, "bias_learn_rate", 1.0),
            getattr(self, "bias_reg", 0.0), self.BIASED,
            update_user, update_item)
        self.W_ext, self.H_ext = sgd.sgd_epoch_blocked(
            self.W_ext, self.H_ext, self._blocked, sub, self._hp(), rates,
            self._freq, meta=tuple(sorted(self._bmeta.items())),
            loss=self.loss_id, biased=self.BIASED,
            frequency_regularization=self.frequency_regularization)
        self.update_learn_rate()

    def update_learn_rate(self):
        self.current_learnrate *= self.learn_rate_decay

    def _params_dict(self):
        f = self.num_factors
        U = self.num_users_trained
        return dict(
            global_bias=jnp.float32(self.global_bias),
            user_factors=self.W_ext[:U, :f],
            item_factors=self.H_ext[:, :f],
            user_bias=self.W_ext[:U, f],
            item_bias=self.H_ext[:, f + 1])

    def compute_objective(self) -> float:
        self._ensure_epoch_ready()
        data = self._flat_data()
        hp = dict(self._hp(),
                  learn_rate=jnp.float32(self.current_learnrate),
                  reg_u=jnp.float32(self.reg_u),
                  reg_i=jnp.float32(self.reg_i),
                  bias_reg=jnp.float32(getattr(self, "bias_reg", 0.0)))
        return float(sgd.mf_objective(
            self._params_dict(), data, hp, self._counts,
            loss=self.loss_id, biased=self.BIASED,
            frequency_regularization=self.frequency_regularization))

    # --- prediction ---

    def _scores(self, users, items):
        """Raw (unbounded) scores for id arrays; out-of-range ids contribute
        only the global bias (reference Predict bounds checks)."""
        U = self.num_users_trained
        I = self.H_ext.shape[0]
        u = jnp.asarray(users, dtype=jnp.int32)
        i = jnp.asarray(items, dtype=jnp.int32)
        uc = jnp.clip(u, 0, self.W_ext.shape[0] - 1)
        ic = jnp.clip(i, 0, I - 1)
        u_ok = (u >= 0) & (u < U)
        i_ok = (i >= 0) & (i < I)
        f = self.num_factors
        wu = self.W_ext[uc]
        hi = self.H_ext[ic]
        dot = jnp.sum(wu[:, :f] * hi[:, :f], axis=-1)
        score = self.global_bias + jnp.where(u_ok & i_ok, dot, 0.0)
        if self.BIASED:
            score = score + jnp.where(u_ok, wu[:, f], 0.0)
            score = score + jnp.where(i_ok, hi[:, f + 1], 0.0)
        return score

    def _bound(self, score):
        return jnp.clip(score, self.min_rating, self.max_rating)

    def predict_batch(self, users, items):
        users = np.asarray(users, dtype=np.int32)
        items = np.asarray(items, dtype=np.int32)
        n = users.size
        # pow2 padding bounds the number of compiled batch shapes
        cap = max(8, 1 << max(n - 1, 0).bit_length())
        if cap != n:
            users = np.pad(users, (0, cap - n))
            items = np.pad(items, (0, cap - n))
        out = _predict_pairs(self.W_ext, self.H_ext,
                             float(self.global_bias),
                             float(self.min_rating),
                             float(self.max_rating),
                             users, items, self.num_users_trained,
                             biased=self.BIASED, bound=self.BOUND)
        return np.asarray(out)[:n]

    BOUND = "clip"  # BiasedMF overrides with "sigmoid"

    def pair_scorer(self):
        if self.W_ext is None:
            return None
        params = dict(W=self.W_ext, H=self.H_ext,
                      global_bias=jnp.float32(self.global_bias),
                      min_rating=jnp.float32(self.min_rating),
                      max_rating=jnp.float32(self.max_rating),
                      num_users=jnp.int32(self.num_users_trained))
        # large user tables go through the banked (windowed) gather
        # variant (ops/gather.py)
        from mymedialite_tpu.ops import gather as bg
        if self.W_ext.shape[0] >= bg.MIN_ROWS:
            return _MF_PAIR_FNS_BANKED[(self.BIASED, self.BOUND)], params
        return _MF_PAIR_FNS[(self.BIASED, self.BOUND)], params

    def catalog_scorer(self):
        if self.W_ext is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        if self.BIASED:
            # fused dot includes both biases
            W, H = self.W_ext, self.H_ext
        else:
            f = self.num_factors
            W, H = self.W_ext[:, :f], self.H_ext[:, :f]
        params = dict(W=W, H=H,
                      global_bias=jnp.float32(self.global_bias),
                      min_rating=jnp.float32(self.min_rating),
                      max_rating=jnp.float32(self.max_rating))
        fn = _mf_catalog_sigmoid if self.BOUND == "sigmoid" \
            else _mf_catalog_clip
        return fn, params

    def score_catalog(self, users):
        return np.asarray(self.score_catalog_device(users))

    # --- incremental updates (reference MatrixFactorization.cs:262-320) ---

    def add_user(self, user_id):
        super().add_user(user_id)
        grow = user_id + 1 - self.W_ext.shape[0]
        if grow > 0:
            G = (self._bmeta or {}).get("group_users", self.group_users)
            grow = ((grow + G - 1) // G) * G
            fe = self.W_ext.shape[1]
            pad = np.zeros((grow, fe), np.float32)
            pad[:, fe - 1] = 1.0
            self.W_ext = jnp.concatenate([self.W_ext, jnp.asarray(pad)])

    def add_item(self, item_id):
        super().add_item(item_id)
        grow = item_id + 1 - self.H_ext.shape[0]
        if grow > 0:
            fe = self.H_ext.shape[1]
            pad = np.zeros((grow, fe), np.float32)
            pad[:, fe - 2] = 1.0
            self.H_ext = jnp.concatenate([self.H_ext, jnp.asarray(pad)])

    def _retrain(self, users, items):
        if self.W_ext is None:
            return
        # invalidate the epoch layout lazily (_ensure_epoch_ready rebuilds
        # on the next iterate()/compute_objective()) — re-blocking and
        # re-shuffling the whole dataset per event would dominate
        # prequential eval (reference AddRatings only touches rows,
        # MatrixFactorization.cs:262-279)
        self._blocked = None
        self._flat_cache = None
        for u in np.unique(np.asarray(users, dtype=np.int64)):
            self.add_user(int(u))
            if self.update_users:
                self.retrain_user(int(u))
        for i in np.unique(np.asarray(items, dtype=np.int64)):
            self.add_item(int(i))
            if self.update_items:
                self.retrain_item(int(i))

    def _online_flush(self):
        self._blocked = None
        self._flat_cache = None

    def _next_key(self):
        """Per-retrain RNG keys, drawn from a 256-key pool refilled with
        one bulk split (one eager dispatch per 256 events instead of one
        split per event)."""
        pool = getattr(self, "_key_pool", None)
        if not pool:
            keys = jax.random.split(self._key, 257)
            host = np.asarray(keys)
            self._key = keys[0]
            self._key_pool = pool = [host[k] for k in range(256, 0, -1)]
        return pool.pop()

    def _fresh_row(self, num_cols, bias_col):
        self._key, sub = jax.random.split(self._key)
        row = np.zeros(num_cols, np.float32)
        row[:self.num_factors] = self.init_mean + self.init_stdev * np.asarray(
            jax.random.normal(sub, (self.num_factors,), dtype=jnp.float32))
        row[bias_col] = 1.0
        return jnp.asarray(row)

    def retrain_user(self, user_id):
        """Fresh row init + num_iter SGD passes over just this user's
        ratings, item side frozen (reference RetrainUser,
        MatrixFactorization.cs:142-150) — one fused jitted call."""
        fe = self.W_ext.shape[1]
        items, vals = self._rated_by_user(user_id)
        idx, v, w = _pad_history(items, vals)
        self.W_ext = _refresh_row(
            self.W_ext, self.H_ext, user_id, self._next_key(),
            self.init_mean, self.init_stdev, idx, v, w,
            self.learn_rate, float(self.reg_u),
            float(getattr(self, "bias_learn_rate", 1.0)),
            float(getattr(self, "bias_reg", 0.0)),
            float(self.global_bias), float(self.min_rating),
            max(self.max_rating - self.min_rating, 1e-9),
            num_iter=self.num_iter, decay=self.learn_rate_decay,
            biased=self.BIASED, loss=self.loss_id,
            frozen_col=fe - 1, bias_col=fe - 2)

    def retrain_item(self, item_id):
        fe = self.H_ext.shape[1]
        users, vals = self._rated_by_item(item_id)
        idx, v, w = _pad_history(users, vals)
        self.H_ext = _refresh_row(
            self.H_ext, self.W_ext, item_id, self._next_key(),
            self.init_mean, self.init_stdev, idx, v, w,
            self.learn_rate, float(self.reg_i),
            float(getattr(self, "bias_learn_rate", 1.0)),
            float(getattr(self, "bias_reg", 0.0)),
            float(self.global_bias), float(self.min_rating),
            max(self.max_rating - self.min_rating, 1e-9),
            num_iter=self.num_iter, decay=self.learn_rate_decay,
            biased=self.BIASED, loss=self.loss_id,
            frozen_col=fe - 2, bias_col=fe - 1)

    def remove_user(self, user_id):
        super().remove_user(user_id)
        fe = self.W_ext.shape[1]
        row = np.zeros(fe, np.float32)
        row[fe - 1] = 1.0
        self.W_ext = self.W_ext.at[user_id].set(jnp.asarray(row))

    def remove_item(self, item_id):
        super().remove_item(item_id)
        fe = self.H_ext.shape[1]
        row = np.zeros(fe, np.float32)
        row[fe - 2] = 1.0
        self.H_ext = self.H_ext.at[item_id].set(jnp.asarray(row))

    # --- fold-in (reference MatrixFactorization.cs:326-352) ---

    def score_items_foldin(self, rated_items, candidates):
        items = np.asarray([i for i, _ in rated_items], dtype=np.int32)
        values = np.asarray([v for _, v in rated_items], dtype=np.float32)
        fe = self.W_ext.shape[1]
        row = self._fresh_row(fe, fe - 1)
        idx, v, w = _pad_history(items, values)
        row = _learn_row(row, self.H_ext[idx], v, w,
                         jnp.float32(self.learn_rate),
                         jnp.float32(self.regularization),
                         jnp.float32(getattr(self, "bias_learn_rate", 1.0)),
                         jnp.float32(getattr(self, "bias_reg", 0.0)),
                         jnp.float32(self.global_bias),
                         jnp.float32(self.min_rating),
                         jnp.float32(max(self.max_rating - self.min_rating,
                                         1e-9)),
                         num_iter=self.num_iter,
                         decay=self.learn_rate_decay,
                         biased=self.BIASED, loss=self.loss_id,
                         frozen_col=fe - 1, bias_col=fe - 2)
        cand = jnp.asarray(list(candidates), dtype=jnp.int32)
        score = self.global_bias + self.H_ext[cand] @ row
        scores = self._bound(score)
        return [(int(i), float(s)) for i, s in zip(cand, np.asarray(scores))]

    # --- persistence (reference MatrixFactorization SaveModel/LoadModel) ---

    def save_model(self, path):
        wu, hi, _, _ = sgd.split_tables(self.W_ext, self.H_ext,
                                        self.num_users_trained)
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_bias)
            w.matrix(wu)
            w.matrix(hi)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            gb = r.scalar()
            wu = r.matrix()
            hi = r.matrix()
        if wu.shape[1] != hi.shape[1]:
            raise IOError("number of user and item factors must match")
        self.num_factors = wu.shape[1]
        self.num_users_trained = wu.shape[0]
        self.num_items_trained = hi.shape[0]
        self.global_bias = gb
        self.W_ext, self.H_ext = sgd.extend_tables(
            wu, hi, group_users=self.group_users)
        self.current_learnrate = self.learn_rate
        self._key = jax.random.PRNGKey(self.random_seed)
        self._key_pool = None
        self._bmeta = dict(ngroups=self.W_ext.shape[0] // min(
            self.group_users, max(wu.shape[0], 1)),
            group_users=min(self.group_users, max(wu.shape[0], 1)),
            batch=self.batch_size, l_pad=0)


@jax.jit
def _sigmoid_pred(score, min_rating, rating_range):
    return min_rating + jax.nn.sigmoid(score) * rating_range


def _learn_row_body(row, other_rows, values, weights, learn_rate, reg,
                    bias_lr, bias_reg, global_bias, min_rating,
                    rating_range, *, num_iter, decay, biased, loss,
                    frozen_col, bias_col):
    """num_iter minibatch updates of a single fused row against frozen
    counterpart rows (reference LearnFactors on ByUser/ByItem lists +
    FoldIn, MatrixFactorization.cs:142-160, 326-352). Traced inside the
    jitted wrappers below; callers pad histories to power-of-two buckets
    (weights mask the padding) so executables are reused across history
    lengths."""
    fe = row.shape[0]
    lr_vec = jnp.full(fe, learn_rate, dtype=jnp.float32)
    lr_vec = lr_vec.at[frozen_col].set(0.0)
    lr_vec = lr_vec.at[bias_col].set(bias_lr * learn_rate if biased else 0.0)
    reg_vec = jnp.full(fe, reg, dtype=jnp.float32)
    reg_vec = reg_vec.at[frozen_col].set(0.0)
    reg_vec = reg_vec.at[bias_col].set(bias_reg * reg if biased else 0.0)
    n_real = jnp.sum(weights)
    lr_scale = 1.0
    for _ in range(num_iter):
        # HIGHEST: training math, a TF32 product would round the rows
        score = jnp.matmul(other_rows, row,
                           precision=jax.lax.Precision.HIGHEST)
        if biased:
            sig = jax.nn.sigmoid(score + global_bias)
            pred = min_rating + sig * rating_range
            err = values - pred
            g = sgd._gradient_common(loss, err, sig, rating_range)
        else:
            g = values - (score + global_bias)
        g = g * weights
        grad = jnp.sum(g[:, None] * other_rows, axis=0) \
            - n_real * reg_vec * row
        row = row + lr_scale * lr_vec * grad
        lr_scale *= decay
    return row


_learn_row = functools.partial(
    jax.jit,
    static_argnames=("num_iter", "decay", "biased", "loss",
                     "frozen_col", "bias_col"))(_learn_row_body)


@functools.partial(
    jax.jit,
    static_argnames=("num_iter", "decay", "biased", "loss",
                     "frozen_col", "bias_col"),
    donate_argnames=("own_table",))
def _refresh_row(own_table, other_table, row_id, key, init_mean, init_stdev,
                 idx, values, weights, learn_rate, reg, bias_lr, bias_reg,
                 global_bias, min_rating, rating_range, *, num_iter, decay,
                 biased, loss, frozen_col, bias_col):
    """Device-resident single-row refresh (reference RetrainUser /
    RetrainItem, MatrixFactorization.cs:142-160): fresh N(mean, stdev)
    row init + the _learn_row loop + write-back, fused into ONE jitted
    call so prequential eval costs two dispatches per event instead of
    ~15 eager ops."""
    fe = own_table.shape[1]
    f = fe - 2
    noise = init_mean + init_stdev * jax.random.normal(key, (f,),
                                                       dtype=jnp.float32)
    row = jnp.zeros(fe, dtype=jnp.float32)
    row = row.at[:f].set(noise)
    row = row.at[frozen_col].set(1.0)
    row = _learn_row_body(row, other_table[idx], values, weights,
                          learn_rate, reg, bias_lr, bias_reg, global_bias,
                          min_rating, rating_range, num_iter=num_iter,
                          decay=decay, biased=biased, loss=loss,
                          frozen_col=frozen_col, bias_col=bias_col)
    return own_table.at[row_id].set(row)


# pair_scorer fns (stable module-level identity per (BIASED, BOUND)
# combo, so the evaluator's fused metric jit caches one compile each)

def _mf_pairs(params, u, i, *, biased, bound):
    return _predict_pairs(params["W"], params["H"], params["global_bias"],
                          params["min_rating"], params["max_rating"],
                          u, i, params["num_users"],
                          biased=biased, bound=bound)


def _mf_pairs_banked(params, u, i, *, biased, bound):
    """Same math as ``_mf_pairs`` but the user-row gather goes through
    windowed table views (ops/gather.py), which keeps each gather's
    source window small on large user tables. The evaluator feeds u
    SORTED in the banked segment layout and injects the window bases as
    ``params["_ugather_bases"]``."""
    from mymedialite_tpu.ops import gather as bg
    W, H = params["W"], params["H"]
    u = jnp.asarray(u, dtype=jnp.int32)
    i = jnp.asarray(i, dtype=jnp.int32)
    wu = bg.banked_take(W, u.reshape(-1, bg.SEG_C),
                        params["_ugather_bases"])
    hi = H[jnp.clip(i, 0, H.shape[0] - 1)]
    return _pairs_from_rows(wu, hi, params["global_bias"],
                            params["min_rating"], params["max_rating"],
                            u, i, params["num_users"], H.shape[0],
                            biased=biased, bound=bound)


def _mf_pairs_clip(p, u, i):
    return _mf_pairs(p, u, i, biased=False, bound="clip")


def _mf_pairs_clip_biased(p, u, i):
    return _mf_pairs(p, u, i, biased=True, bound="clip")


def _mf_pairs_sig(p, u, i):
    return _mf_pairs(p, u, i, biased=False, bound="sigmoid")


def _mf_pairs_sig_biased(p, u, i):
    return _mf_pairs(p, u, i, biased=True, bound="sigmoid")


def _mf_pairs_banked_clip(p, u, i):
    return _mf_pairs_banked(p, u, i, biased=False, bound="clip")


def _mf_pairs_banked_clip_biased(p, u, i):
    return _mf_pairs_banked(p, u, i, biased=True, bound="clip")


def _mf_pairs_banked_sig(p, u, i):
    return _mf_pairs_banked(p, u, i, biased=False, bound="sigmoid")


def _mf_pairs_banked_sig_biased(p, u, i):
    return _mf_pairs_banked(p, u, i, biased=True, bound="sigmoid")


_MF_PAIR_FNS = {
    (False, "clip"): _mf_pairs_clip,
    (True, "clip"): _mf_pairs_clip_biased,
    (False, "sigmoid"): _mf_pairs_sig,
    (True, "sigmoid"): _mf_pairs_sig_biased,
}

_MF_PAIR_FNS_BANKED = {
    (False, "clip"): _mf_pairs_banked_clip,
    (True, "clip"): _mf_pairs_banked_clip_biased,
    (False, "sigmoid"): _mf_pairs_banked_sig,
    (True, "sigmoid"): _mf_pairs_banked_sig_biased,
}
for _fn in _MF_PAIR_FNS_BANKED.values():
    _fn.WANTS_UGATHER = True


def _pairs_from_rows(wu, hi, global_bias, min_rating, max_rating,
                     u, i, num_users, num_item_rows, *, biased, bound):
    """Score from pre-gathered table rows (shared by the plain and the
    banked-gather pair paths; out-of-range ids contribute only the
    global bias)."""
    f = wu.shape[1] - 2
    u_ok = (u >= 0) & (u < num_users)
    i_ok = (i >= 0) & (i < num_item_rows)
    dot = jnp.sum(wu[:, :f] * hi[:, :f], axis=-1)
    score = global_bias + jnp.where(u_ok & i_ok, dot, 0.0)
    if biased:
        score = score + jnp.where(u_ok, wu[:, f], 0.0)
        score = score + jnp.where(i_ok, hi[:, f + 1], 0.0)
    if bound == "sigmoid":
        return min_rating + jax.nn.sigmoid(score) * (max_rating - min_rating)
    return jnp.clip(score, min_rating, max_rating)


@functools.partial(jax.jit, static_argnames=("biased", "bound"))
def _predict_pairs(W_ext, H_ext, global_bias, min_rating, max_rating,
                   users, items, num_users, *, biased, bound):
    """Jitted pairwise prediction on the fused tables (one dispatch per
    batch)."""
    u = jnp.asarray(users, dtype=jnp.int32)
    i = jnp.asarray(items, dtype=jnp.int32)
    wu = W_ext[jnp.clip(u, 0, W_ext.shape[0] - 1)]
    hi = H_ext[jnp.clip(i, 0, H_ext.shape[0] - 1)]
    return _pairs_from_rows(wu, hi, global_bias, min_rating, max_rating,
                            u, i, num_users, H_ext.shape[0],
                            biased=biased, bound=bound)


def _pad_history(items, values, min_size: int = 8):
    """Pad (ids, values) to the next power-of-two bucket with a 0/1
    weight mask, bounding the number of _learn_row recompilations.
    Returns numpy arrays — the jitted callee does the device transfer,
    avoiding per-call eager dispatches."""
    L = int(np.asarray(values).size)
    cap = max(min_size, 1 << max(L - 1, 0).bit_length())
    idx = np.zeros(cap, np.int32)
    v = np.zeros(cap, np.float32)
    w = np.zeros(cap, np.float32)
    idx[:L] = items
    v[:L] = values
    w[:L] = 1.0
    return idx, v, w


class BiasedMatrixFactorization(MatrixFactorization):
    """The flagship rating predictor (reference
    BiasedMatrixFactorization.cs:77): prediction =
    min + sigmoid(global + b_u + b_i + <w_u,h_i>) * range."""

    HYPERPARAMS = {
        "num_factors": int,
        "bias_reg": float,
        "reg_u": float,
        "reg_i": float,
        "frequency_regularization": bool,
        "learn_rate": float,
        "bias_learn_rate": float,
        "learn_rate_decay": float,
        "num_iter": int,
        "bold_driver": bool,
        "loss": OptimizationTarget,
        "max_threads": int,
        "naive_parallelization": bool,
    }
    EXTRA_PARAMS = {
        "regularization": float,
        "init_mean": float,
        "init_stdev": float,
        "batch_size": int,
        "group_users": int,
    }

    BIASED = True

    def __init__(self):
        super().__init__()
        # defaults per reference BiasedMatrixFactorization.cs:85-92
        self.bias_reg = 0.01
        self.bias_learn_rate = 1.0
        self.frequency_regularization = False
        self.bold_driver = False
        self.loss = OptimizationTarget.RMSE
        self.max_threads = 1              # accepted for CLI compat
        self.naive_parallelization = False
        self._last_loss = -math.inf

    # BiasedMF's Regularization setter fans out to RegU/RegI
    # (reference BiasedMatrixFactorization.cs:96-103)
    @property
    def regularization(self):
        return getattr(self, "_regularization", 0.015)

    @regularization.setter
    def regularization(self, v):
        self._regularization = float(v)
        self._reg_u = float(v)
        self._reg_i = float(v)

    @property
    def frequency_regularization(self):
        return getattr(self, "_freq_reg", False)

    @frequency_regularization.setter
    def frequency_regularization(self, v):
        self._freq_reg = bool(v)

    @property
    def loss_id(self):
        return _LOSS_ID[self.loss]

    def _init_global_bias(self):
        # logit of normalized average (reference Train :188-190)
        rng = max(self.max_rating - self.min_rating, 1e-9)
        avg = (self.ratings.average - self.min_rating) / rng
        avg = min(max(avg, 1e-6), 1 - 1e-6)
        return math.log(avg / (1 - avg))

    def init_model(self):
        super().init_model()
        if self.bold_driver:
            self._last_loss = self.compute_objective()

    def update_learn_rate(self):
        """Bold driver (reference UpdateLearnRate :225-244): halve on
        objective increase, *1.05 on decrease."""
        if self.bold_driver:
            loss = self.compute_objective()
            if loss > self._last_loss:
                self.current_learnrate *= 0.5
            elif loss < self._last_loss:
                self.current_learnrate *= 1.05
            self._last_loss = loss
        else:
            self.current_learnrate *= self.learn_rate_decay

    BOUND = "sigmoid"

    def _bound(self, score):
        rng = max(self.max_rating - self.min_rating, 1e-9)
        return self.min_rating + jax.nn.sigmoid(score) * rng

    # persistence (reference BiasedMatrixFactorization.cs:339-402)

    def save_model(self, path):
        wu, hi, bu, bi = sgd.split_tables(self.W_ext, self.H_ext,
                                          self.num_users_trained)
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_bias)
            w.scalar(self.min_rating)
            w.scalar(self.max_rating)
            w.vector(bu)
            w.matrix(wu)
            w.vector(bi)
            w.matrix(hi)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            gb = r.scalar()
            self.min_rating = r.scalar()
            self.max_rating = r.scalar()
            bu = r.vector()
            wu = r.matrix()
            bi = r.vector()
            hi = r.matrix()
        if wu.shape[1] != hi.shape[1]:
            raise IOError("number of user and item factors must match")
        if bu.shape[0] != wu.shape[0] or bi.shape[0] != hi.shape[0]:
            raise IOError("bias/factor dimensions must match")
        self.num_factors = wu.shape[1]
        self.num_users_trained = wu.shape[0]
        self.num_items_trained = hi.shape[0]
        self.global_bias = gb
        self.W_ext, self.H_ext = sgd.extend_tables(
            wu, hi, bu, bi, group_users=self.group_users)
        self.current_learnrate = self.learn_rate
        self._key = jax.random.PRNGKey(self.random_seed)
        self._key_pool = None
        self._bmeta = dict(ngroups=self.W_ext.shape[0] // min(
            self.group_users, max(wu.shape[0], 1)),
            group_users=min(self.group_users, max(wu.shape[0], 1)),
            batch=self.batch_size, l_pad=0)
