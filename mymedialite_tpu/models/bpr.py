"""BPR-family item recommenders.

JAX counterparts of reference
``ItemRecommendation/MF.cs:29`` (abstract implicit-MF base),
``BPRMF.cs:73`` (the flagship ranking model),
``WeightedBPRMF.cs:32`` (WBPR popularity sampling),
``SoftMarginRankingMF.cs:52`` (hinge loss),
``MultiCoreBPRMF.cs:30`` (hogwild parallel BPR — here the same jitted
minibatch path; XLA + sharding provide the parallelism).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu.models.base import (
    FoldInItemRecommender, IncrementalItemRecommender, IterativeModel,
)
from mymedialite_tpu.ops import bpr as bpr_ops


def _itemmf_catalog(params, users):
    """Pure catalog scorer for implicit-MF models (module-level: stable
    jit identity; see Recommender.catalog_scorer). Default matmul
    precision, as for every catalog scorer (eval/ranking.py)."""
    u = jnp.clip(users, 0, params["user_factors"].shape[0] - 1)
    score = params["user_factors"][u] @ params["item_factors"].T
    if "item_bias" in params:
        score = score + params["item_bias"][None, :]
    return score


class ItemMF(IncrementalItemRecommender, IterativeModel):
    """Shared factor storage / init / predict / save-load for implicit-MF
    models (reference ItemRecommendation/MF.cs:29-196)."""

    EXTRA_PARAMS = {
        "init_mean": float,
        "init_stdev": float,
        "batch_size": int,
    }

    def __init__(self):
        super().__init__()
        self.num_factors = 10
        self.num_iter = 30
        self.init_mean = 0.0
        self.init_stdev = 0.1
        self.batch_size = 8192
        self.random_seed = 42
        self.params = None
        self._key = None

    def init_model(self):
        f = self.feedback
        key = jax.random.PRNGKey(self.random_seed)
        self._key, ku, ki = jax.random.split(key, 3)
        self.params = dict(
            user_factors=self.init_mean + self.init_stdev * jax.random.normal(
                ku, (f.num_users, self.num_factors), dtype=jnp.float32),
            item_factors=self.init_mean + self.init_stdev * jax.random.normal(
                ki, (f.num_items, self.num_factors), dtype=jnp.float32),
        )

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def iterate(self):
        raise NotImplementedError

    def predict_batch(self, users, items):
        p = self.params
        U, I = p["user_factors"].shape[0], p["item_factors"].shape[0]
        u = jnp.asarray(users, dtype=jnp.int32)
        i = jnp.asarray(items, dtype=jnp.int32)
        ok = (u >= 0) & (u < U) & (i >= 0) & (i < I)
        uc = jnp.clip(u, 0, U - 1)
        ic = jnp.clip(i, 0, I - 1)
        score = jnp.sum(p["user_factors"][uc] * p["item_factors"][ic], axis=-1)
        if "item_bias" in p:
            score = score + p["item_bias"][ic]
        # unknown entities score float.MinValue (reference MF.Predict/BPRMF)
        return np.asarray(jnp.where(ok, score, -np.float32(3.4e38)))

    def catalog_scorer(self):
        if self.params is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        p = self.params
        params = dict(user_factors=p["user_factors"],
                      item_factors=p["item_factors"])
        if "item_bias" in p:
            params["item_bias"] = p["item_bias"]
        return _itemmf_catalog, params

    def score_catalog(self, users):
        return np.asarray(self.score_catalog_device(users))

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.matrix(np.asarray(self.params["user_factors"]))
            if "item_bias" in self.params:
                w.vector(np.asarray(self.params["item_bias"]))
            w.matrix(np.asarray(self.params["item_factors"]))

    def load_model(self, path):
        has_bias = "item_bias" in (self.params or {}) or self.HAS_ITEM_BIAS
        with ModelReader(path, type(self).__name__) as r:
            wu = r.matrix()
            bias = r.vector() if has_bias else None
            hi = r.matrix()
        if wu.shape[1] != hi.shape[1]:
            raise IOError("number of user and item factors must match")
        self.num_factors = wu.shape[1]
        self.num_users_trained = wu.shape[0]
        self.num_items_trained = hi.shape[0]
        self.params = dict(user_factors=jnp.asarray(wu),
                           item_factors=jnp.asarray(hi))
        if bias is not None:
            self.params["item_bias"] = jnp.asarray(bias)
        self._key = jax.random.PRNGKey(self.random_seed)

    HAS_ITEM_BIAS = False


class BPRMF(ItemMF, FoldInItemRecommender):
    """Bayesian Personalized Ranking MF (reference BPRMF.cs:73-553).

    SGD over sampled (user, pos-item, neg-item) triples; four sampling
    regimes; item bias; separate RegU/RegI/RegJ. One iteration performs
    |feedback| triple updates, minibatched on device.
    """

    HYPERPARAMS = {
        "num_factors": int,
        "bias_reg": float,
        "reg_u": float,
        "reg_i": float,
        "reg_j": float,
        "num_iter": int,
        "learn_rate": float,
        "uniform_user_sampling": bool,
        "with_replacement": bool,
        "update_j": bool,
    }
    EXTRA_PARAMS = dict(ItemMF.EXTRA_PARAMS, num_neg_trials=int)

    HAS_ITEM_BIAS = True
    SOFT_MARGIN = False

    def __init__(self):
        super().__init__()
        # defaults per reference BPRMF.cs:78-101
        self.bias_reg = 0.0
        self.reg_u = 0.0025
        self.reg_i = 0.0025
        self.reg_j = 0.00025
        self.learn_rate = 0.05
        self.uniform_user_sampling = True
        self.with_replacement = False
        self.update_j = True
        self.num_neg_trials = 8
        self._sampler = None
        self._loss_sample = None

    # incremental-update flags (reference BPRMF ctor: update item factors
    # off by default for online updates)
    update_users = True
    update_items = False

    def _regime(self):
        if self.uniform_user_sampling:
            # with/without replacement collapse to iid uniform-user on
            # device (the reference's without-replacement path is also an
            # iid SampleTriple loop, BPRMF.cs:228-238)
            return bpr_ops.UNIFORM_USER
        return (bpr_ops.UNIFORM_PAIR if self.with_replacement
                else bpr_ops.UNIFORM_PAIR_WOR)

    def _hp(self):
        return dict(learn_rate=jnp.float32(self.learn_rate),
                    reg_u=jnp.float32(self.reg_u),
                    reg_i=jnp.float32(self.reg_i),
                    reg_j=jnp.float32(self.reg_j),
                    bias_reg=jnp.float32(self.bias_reg))

    def init_model(self):
        super().init_model()
        self.params["item_bias"] = jnp.zeros(self.feedback.num_items,
                                             dtype=jnp.float32)
        self._build_epoch_state()

    def _build_epoch_state(self):
        """(Re)build all feedback-derived training state: the sampler
        arrays, the WBPR popularity CDF, and the fixed convergence-loss
        triple sample (reference BPRMF.cs:135-150: sqrt(|U|) * 100
        triples)."""
        self._sampler, meta = bpr_ops.make_sampler_data(
            self.feedback, self.num_neg_trials)
        self._meta = meta
        self._pop_cdf = self._make_pop_cdf()
        n_sample = int(math.isqrt(max(self.feedback.num_users - 1, 1))) * 100
        self._key, sub = jax.random.split(self._key)
        u, i, j, w = bpr_ops._sample_triples(
            sub, self._sampler, dict(meta), max(n_sample, 1),
            bpr_ops.UNIFORM_USER)
        self._loss_sample = (u, i, j)

    def _ensure_epoch_ready(self):
        """Lazily rebuild feedback-derived state when missing — e.g. after
        ``load_model`` — so ``iterate()``/``compute_objective()`` keep
        working without a fresh ``train()`` (reference Model.Load
        re-creates a recommender that can keep training, IO/Model.cs:67-83;
        the CLI's --load-model + --find-iter flow). Mirrors
        models/mf.py's _ensure_epoch_ready for the rating-MF family."""
        if self._sampler is not None:
            return
        if self.feedback is None:
            raise RuntimeError(
                f"{type(self).__name__}: no feedback set; assign "
                ".feedback before iterating a loaded model")
        self._grow_tables()
        self._build_epoch_state()

    def _make_pop_cdf(self):
        return None

    def iterate(self):
        self._ensure_epoch_ready()
        meta = self._meta
        batch = min(self.batch_size, max(meta["num_events"], 1))
        num_batches = max((meta["num_events"] + batch - 1) // batch, 1)
        self._key, sub = jax.random.split(self._key)
        self.params = bpr_ops.bpr_epoch(
            self.params, self._sampler, sub, self._hp(),
            self._pop_cdf if self._pop_cdf is not None else jnp.zeros(0),
            batch_size=batch, num_batches=num_batches,
            regime=self._regime() if self._pop_cdf is None else bpr_ops.WBPR,
            meta_static=tuple(sorted(meta.items())),
            update_j=self.update_j, soft_margin=self.SOFT_MARGIN)

    def compute_objective(self):
        self._ensure_epoch_ready()
        u, i, j = self._loss_sample
        return float(bpr_ops.bpr_objective(self.params, self._hp(), u, i, j))

    # --- incremental updates (reference BPRMF.cs:391-422) ---

    def _grow_tables(self):
        f = self.feedback
        p = self.params
        grow_u = f.num_users - p["user_factors"].shape[0]
        if grow_u > 0:
            self._key, sub = jax.random.split(self._key)
            rows = self.init_mean + self.init_stdev * jax.random.normal(
                sub, (grow_u, self.num_factors), dtype=jnp.float32)
            p["user_factors"] = jnp.concatenate([p["user_factors"], rows])
        grow_i = f.num_items - p["item_factors"].shape[0]
        if grow_i > 0:
            self._key, sub = jax.random.split(self._key)
            rows = self.init_mean + self.init_stdev * jax.random.normal(
                sub, (grow_i, self.num_factors), dtype=jnp.float32)
            p["item_factors"] = jnp.concatenate([p["item_factors"], rows])
            p["item_bias"] = jnp.concatenate(
                [p["item_bias"], jnp.zeros(grow_i)])
        self.num_users_trained = max(self.num_users_trained, f.num_users)
        self.num_items_trained = max(self.num_items_trained, f.num_items)

    def _retrain(self, users, items):
        if self.params is None:
            return
        self._ensure_epoch_ready()  # loaded model: build full state first
        self._grow_tables()
        self._sampler, self._meta = bpr_ops.make_sampler_data(
            self.feedback, self.num_neg_trials)
        self._pop_cdf = self._make_pop_cdf()
        if self.update_users:
            for u in np.unique(np.asarray(users, dtype=np.int64)):
                self.retrain_user(int(u))
        if self.update_items:
            for i in np.unique(np.asarray(items, dtype=np.int64)):
                self.retrain_item(int(i))

    def retrain_user(self, user_id):
        """Fresh row + |I_u| pairwise updates on this user's pairs
        (reference RetrainUser, BPRMF.cs:391-403)."""
        self._key, sub = jax.random.split(self._key)
        row = self.init_mean + self.init_stdev * jax.random.normal(
            sub, (self.num_factors,), dtype=jnp.float32)
        self.params["user_factors"] = \
            self.params["user_factors"].at[user_id].set(row)
        items_u = self.feedback.items_by_user(user_id)
        n = int(items_u.size)
        if n == 0:
            return
        meta = dict(self._meta)
        self._key, k_i, k_j = jax.random.split(self._key, 3)
        pos = jnp.asarray(items_u)[jax.random.randint(k_i, (n,), 0, n)]
        users = jnp.full((n,), user_id, dtype=jnp.int32)
        neg, ok = bpr_ops._sample_negatives(
            k_j, self._sampler, users, meta["num_items"],
            meta["num_neg_trials"], meta["search_depth"])
        self._pairwise_updates(users, pos, neg, ok.astype(jnp.float32),
                               update_u=True, update_i=False, update_j=False)

    def retrain_item(self, item_id):
        """Reference RetrainItem (BPRMF.cs:405-422), vectorized."""
        self._key, sub = jax.random.split(self._key)
        row = self.init_mean + self.init_stdev * jax.random.normal(
            sub, (self.num_factors,), dtype=jnp.float32)
        self.params["item_factors"] = \
            self.params["item_factors"].at[item_id].set(row)
        meta = dict(self._meta)
        n = max(meta["num_events"] // max(meta["num_items"], 1), 1)
        self._key, k_u, k_j = jax.random.split(self._key, 3)
        uidx = jax.random.randint(
            k_u, (n,), 0, self._sampler["valid_users"].shape[0])
        users = self._sampler["valid_users"][uidx]
        # is item_id positive for each sampled user?
        is_pos = bpr_ops._segment_contains(
            self._sampler["hist_items"], self._sampler["indptr"], users,
            jnp.full((n,), item_id, dtype=jnp.int32), meta["search_depth"])
        other, ok = bpr_ops._sample_negatives(
            k_j, self._sampler, users, meta["num_items"],
            meta["num_neg_trials"], meta["search_depth"])
        this = jnp.full((n,), item_id, dtype=jnp.int32)
        pos = jnp.where(is_pos, this, other)
        neg = jnp.where(is_pos, other, this)
        w = ok.astype(jnp.float32)
        self._pairwise_updates(users, pos, neg, w * is_pos,
                               update_u=False, update_i=True, update_j=False)
        self._pairwise_updates(users, pos, neg, w * (~is_pos),
                               update_u=False, update_i=False, update_j=True)

    def _pairwise_updates(self, u, i, j, w, update_u, update_i, update_j):
        p = self.params
        lr = self.learn_rate
        wu = p["user_factors"][u]
        hi = p["item_factors"][i]
        hj = p["item_factors"][j]
        x = p["item_bias"][i] - p["item_bias"][j] + jnp.sum(wu * (hi - hj), -1)
        g = jax.nn.sigmoid(-x) * w
        if update_u:
            p["user_factors"] = p["user_factors"].at[u].add(
                lr * (g[:, None] * (hi - hj) - (w * self.reg_u)[:, None] * wu))
        if update_i:
            p["item_factors"] = p["item_factors"].at[i].add(
                lr * (g[:, None] * wu - (w * self.reg_i)[:, None] * hi))
            p["item_bias"] = p["item_bias"].at[i].add(
                lr * (g - self.bias_reg * w * p["item_bias"][i]))
        if update_j:
            p["item_factors"] = p["item_factors"].at[j].add(
                lr * (-g[:, None] * wu - (w * self.reg_j)[:, None] * hj))
            p["item_bias"] = p["item_bias"].at[j].add(
                lr * (-g - self.bias_reg * w * p["item_bias"][j]))

    # --- fold-in (reference BPRMF.cs:497-542) ---

    def score_items_foldin(self, accessed_items, candidates):
        """Learn a user vector for an unseen user: |I_u| BPR updates per
        iteration over the user's accessed items vs sampled negatives."""
        pos_set = np.unique(np.asarray(list(accessed_items), dtype=np.int32))
        I = self.params["item_factors"].shape[0]
        self._key, sub = jax.random.split(self._key)
        vec = self.init_mean + self.init_stdev * jax.random.normal(
            sub, (self.num_factors,), dtype=jnp.float32)
        neg_pool = np.setdiff1d(np.arange(I, dtype=np.int32), pos_set)
        rng = np.random.default_rng(int(jax.random.randint(sub, (), 0, 2**31 - 1)))
        for _ in range(self.num_iter):
            pos = rng.choice(pos_set, size=pos_set.size)
            neg = rng.choice(neg_pool, size=pos_set.size) if neg_pool.size \
                else pos
            hi = self.params["item_factors"][jnp.asarray(pos)]
            hj = self.params["item_factors"][jnp.asarray(neg)]
            x = self.params["item_bias"][jnp.asarray(pos)] - \
                self.params["item_bias"][jnp.asarray(neg)] + jnp.matmul(
                    hi - hj, vec, precision=jax.lax.Precision.HIGHEST)
            g = jax.nn.sigmoid(-x)
            vec = vec + self.learn_rate * (
                jnp.sum(g[:, None] * (hi - hj), axis=0)
                - self.reg_u * vec * pos_set.size)
        cand = jnp.asarray(list(candidates), dtype=jnp.int32)
        scores = self.params["item_bias"][cand] + \
            self.params["item_factors"][cand] @ vec
        return [(int(c), float(s)) for c, s in zip(cand, np.asarray(scores))]


class MultiCoreBPRMF(BPRMF):
    """Reference MultiCoreBPRMF.cs:30 — hogwild-parallel BPR over index
    blocks. Here: with more than one jax device, users are
    range-partitioned across a 1-D mesh; each device samples triples for
    its own users on-device (conflict-free user updates, stronger than
    the reference's tolerated races) and item deltas are psum'd per
    minibatch (ops/bpr.py bpr_epoch_sharded). Single-device, the
    minibatched epoch already is the parallel path."""

    HYPERPARAMS = dict(BPRMF.HYPERPARAMS, max_threads=int)

    def __init__(self):
        super().__init__()
        self.max_threads = 1
        self._mesh = None
        self._sharded = None

    def _setup_mesh(self):
        import jax
        if len(jax.devices()) <= 1:
            return None
        from mymedialite_tpu.parallel.mesh import make_mesh
        self._mesh = make_mesh()
        self._sharded, self._sharded_meta = \
            bpr_ops.make_sampler_data_sharded(
                self.feedback, self._mesh.devices.size, self.num_neg_trials)
        return self._mesh

    def init_model(self):
        super().init_model()
        self._setup_mesh()

    def _ensure_epoch_ready(self):
        rebuilt = self._sampler is None
        super()._ensure_epoch_ready()
        if rebuilt and self._mesh is None:
            self._setup_mesh()

    def iterate(self):
        self._ensure_epoch_ready()
        if self._mesh is None:
            return super().iterate()
        import jax
        from mymedialite_tpu.parallel.mesh import (
            pad_rows_to_multiple, replicated, row_sharded_2d,
        )
        mesh = self._mesh
        n = mesh.devices.size
        meta = self._sharded_meta
        U = self.params["user_factors"].shape[0]
        W = jax.device_put(
            pad_rows_to_multiple(np.asarray(self.params["user_factors"]),
                                 meta["u_loc"] * n), row_sharded_2d(mesh))
        H = jax.device_put(np.asarray(self.params["item_factors"]),
                           replicated(mesh))
        ib = jax.device_put(np.asarray(self.params["item_bias"]),
                            replicated(mesh))
        # per-device batches sum to one reference iteration (|events|
        # triple updates across the mesh)
        events = max(meta["num_events"], 1)
        batch = min(self.batch_size, max(events // n, 1))
        num_batches = max((events + n * batch - 1) // (n * batch), 1)
        self._key, sub = jax.random.split(self._key)
        out = bpr_ops.bpr_epoch_sharded(
            mesh, dict(user_factors=W, item_factors=H, item_bias=ib),
            self._sharded, sub, self._hp(),
            self._pop_cdf, batch_size=batch, num_batches=num_batches,
            regime=self._regime() if self._pop_cdf is None else bpr_ops.WBPR,
            meta_static=tuple(sorted(meta.items())),
            update_j=self.update_j, soft_margin=self.SOFT_MARGIN)
        self.params["user_factors"] = jnp.asarray(
            np.asarray(out["user_factors"])[:U])
        self.params["item_factors"] = jnp.asarray(
            np.asarray(out["item_factors"]))
        self.params["item_bias"] = jnp.asarray(np.asarray(out["item_bias"]))

    def _retrain(self, users, items):
        super()._retrain(users, items)
        if self._mesh is not None:
            self._setup_mesh()


class WeightedBPRMF(BPRMF):
    """WBPR (reference WeightedBPRMF.cs:32): users sampled by activity
    ((u,i) ~ uniform over events), negatives by popularity."""

    HYPERPARAMS = {
        "num_factors": int,
        "bias_reg": float,
        "reg_u": float,
        "reg_i": float,
        "reg_j": float,
        "num_iter": int,
        "learn_rate": float,
    }

    def _make_pop_cdf(self):
        return bpr_ops.popularity_cdf(self.feedback)

    def _regime(self):
        return bpr_ops.WBPR


class SoftMarginRankingMF(BPRMF):
    """Hinge-loss (soft-margin) ranking MF (reference
    SoftMarginRankingMF.cs:52): updates only on margin violation."""

    SOFT_MARGIN = True

    def __init__(self):
        super().__init__()
        self.learn_rate = 0.1  # reference default
