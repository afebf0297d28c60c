"""SVD++ / asymmetric-factor-model family of rating predictors.

JAX counterparts of reference
``RatingPrediction/SVDPlusPlus.cs:43`` (Koren's SVD++, transductive),
``SigmoidSVDPlusPlus.cs:42`` (sigmoid bound + selectable loss),
``SigmoidItemAsymmetricFactorModel.cs:29`` (no p: user expressed purely
by rated items), ``SigmoidUserAsymmetricFactorModel.cs:43`` (mirrored:
items expressed by their raters), ``SigmoidCombinedAsymmetricFactorModel``
(both directions), using the grouped segment-sum epochs in ops/svdpp.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu.models.base import (
    IncrementalRatingPredictor, IterativeModel,
)
from mymedialite_tpu.models.mf import OptimizationTarget, _LOSS_ID
from mymedialite_tpu.ops import sgd, svdpp as svdpp_ops


def _svdpp_catalog_raw(params, users):
    """Pure catalog scorer for the SVD++ family (module-level: stable
    jit identity; see Recommender.catalog_scorer)."""
    uf = params["uf"]
    u = jnp.clip(users, 0, uf.shape[0] - 1)
    return params["global_bias"] + params["user_bias"][u][:, None] + \
        params["item_bias"][None, :] + uf[u] @ params["item_factors"].T


def _svdpp_catalog_clip(params, users):
    return jnp.clip(_svdpp_catalog_raw(params, users),
                    params["min_rating"], params["max_rating"])


def _svdpp_catalog_sigmoid(params, users):
    rng = jnp.maximum(params["max_rating"] - params["min_rating"], 1e-9)
    return params["min_rating"] + \
        jax.nn.sigmoid(_svdpp_catalog_raw(params, users)) * rng


def _svdpp_catalog_combined(params, users):
    return 0.5 * (_svdpp_catalog_sigmoid(params["item"], users)
                  + _svdpp_catalog_sigmoid(params["user"], users))


class SVDPlusPlus(IncrementalRatingPredictor, IterativeModel):
    """prediction(u,i) = mu + b_u + b_i + <q_i, p_u + |I_u|^-1/2 sum y_j>,
    clamped; transductive (test-user histories join I_u via
    ``additional_feedback``)."""

    HYPERPARAMS = {
        "num_factors": int,
        "regularization": float,
        "bias_reg": float,
        "frequency_regularization": bool,
        "learn_rate": float,
        "bias_learn_rate": float,
        "learn_rate_decay": float,
        "num_iter": int,
    }
    EXTRA_PARAMS = {
        "init_mean": float,
        "init_stdev": float,
        "group_users": int,
    }

    SIGMOID = False
    USE_P = True
    SHARDABLE = True  # mesh-sharded epochs (ops/svdpp.py svdpp_epoch_sharded)

    def __init__(self):
        super().__init__()
        # defaults per reference SVDPlusPlus.cs:77-84
        self.num_factors = 10
        self.regularization = 0.015
        self.bias_reg = 0.33
        self.learn_rate = 0.001
        self.bias_learn_rate = 0.7
        self.learn_rate_decay = 1.0
        self.num_iter = 30
        self.frequency_regularization = False
        self.init_mean = 0.0
        self.init_stdev = 0.1
        self.group_users = 0  # 0 = auto-size (see _auto_group_users)
        self.random_seed = 42
        self.loss = OptimizationTarget.RMSE

        self.additional_feedback = None  # (users, items) arrays or None
        self.params = None
        self.current_learnrate = None
        self._user_factors_cache = None

    # --- data plumbing ---

    def _history_edges(self):
        """I_u = training items + additional (test) feedback
        (reference ITransductiveRatingPredictor.ItemsRatedByUser :63)."""
        users = [np.asarray(self.ratings.users)]
        items = [np.asarray(self.ratings.items)]
        if self.additional_feedback is not None:
            au, ai = self.additional_feedback
            users.append(np.asarray(au, dtype=np.int32))
            items.append(np.asarray(ai, dtype=np.int32))
        u = np.concatenate(users)
        i = np.concatenate(items)
        # dedup (u, item) pairs like the reference's per-user HashSets
        key = u.astype(np.int64) * max(self._num_items(), 1) + i
        _, first = np.unique(key, return_index=True)
        return u[first], i[first]

    def _num_users(self):
        n = self.ratings.num_users
        if self.additional_feedback is not None:
            n = max(n, int(np.max(self.additional_feedback[0])) + 1
                    if len(self.additional_feedback[0]) else n)
        return n

    def _num_items(self):
        n = self.ratings.num_items
        if self.additional_feedback is not None and \
                len(self.additional_feedback[1]):
            n = max(n, int(np.max(self.additional_feedback[1])) + 1)
        return n

    def _auto_group_users(self, num_users: int) -> int:
        """Bound the ratings aggregated into one y-update. The y matrix
        is refreshed once per user group; a group whose ratings sum past
        ~10^5 turns the epoch into near-full-batch gradient descent on
        popular items' y rows and diverges (the reference's sequential
        per-rating loop, SVDPlusPlus.cs:157-213, self-corrects after
        every rating). Measured on 1M-rating ML-1M-shaped data:
        ~340k ratings/group diverges by epoch 3, <=84k converges to the
        same RMSE as tiny groups."""
        if self.group_users > 0:
            return min(self.group_users, max(num_users, 1))
        avg = max(1.0, len(self.ratings) / max(num_users, 1))
        # the aggregate y step per group scales with lr * ratings/group:
        # shrink the rating budget proportionally for elevated learn rates
        budget = 65_536.0 * min(1.0, 0.001 / max(self.learn_rate, 1e-9))
        g = int(2 ** np.floor(np.log2(max(budget / avg, 64.0))))
        return min(g, 16_384, max(num_users, 1))

    def _setup_mesh(self):
        """Shard the user-group axis over the mesh when more than one
        device is available (reference SVDPlusPlus under the DSGD
        schedule of MultiCore.cs:43-73)."""
        if not self.SHARDABLE:
            return None
        if len(jax.devices()) <= 1:
            return None
        from mymedialite_tpu.parallel.mesh import make_mesh
        return make_mesh()

    def _prepare(self):
        hu, hi = self._history_edges()
        U, I = self._num_users(), self._num_items()
        G = self._auto_group_users(U)
        self._mesh = self._setup_mesh()
        pad_mult = self._mesh.devices.size if self._mesh is not None else 1
        self._data, meta = svdpp_ops.prepare_groups(
            self.ratings, hu, hi, U, I, G, pad_groups_multiple=pad_mult)
        self._meta = meta
        self.num_users_trained = U
        self.num_items_trained = I
        # per-entity regularization weights
        reg = self.regularization
        cu = np.zeros(U); ci = np.zeros(I)
        np.add.at(cu, self.ratings.users, 1)
        np.add.at(ci, self.ratings.items, 1)
        if self.frequency_regularization:
            user_reg = np.where(cu > 0, reg / np.sqrt(np.maximum(cu, 1)), reg)
            item_reg = np.where(ci > 0, reg / np.sqrt(np.maximum(ci, 1)), reg)
        else:
            user_reg = np.full(U, reg)
            item_reg = np.full(I, reg)
        # y regularization by feedback count (SVDPlusPlus.cs:95-100)
        fc = np.zeros(I)
        np.add.at(fc, hi, 1)
        if self.frequency_regularization:
            y_reg = np.where(fc > 0, reg / np.sqrt(np.maximum(fc, 1)), 0.0)
        else:
            y_reg = np.where(fc > 0, reg, 0.0)
        # pad user-indexed vectors to the group grid
        U_pad = meta["ngroups"] * meta["group_users"]
        self._hp_arrays = dict(
            user_reg=jnp.asarray(np.pad(user_reg, (0, U_pad - U))
                                 .astype(np.float32)),
            item_reg=jnp.asarray(item_reg.astype(np.float32)),
            y_reg=jnp.asarray(y_reg.astype(np.float32)),
        )
        self._U_pad = U_pad

    def _hp(self):
        rng = max(self.max_rating - self.min_rating, 1e-9)
        return dict(
            learn_rate=jnp.float32(self.current_learnrate),
            bias_learn_rate=jnp.float32(self.bias_learn_rate),
            bias_reg=jnp.float32(self.bias_reg),
            min_rating=jnp.float32(self.min_rating),
            rating_range=jnp.float32(rng),
            **self._hp_arrays,
        )

    def _init_global_bias(self):
        return float(self.ratings.average)

    def init_model(self):
        self._prepare()
        key = jax.random.PRNGKey(self.random_seed)
        self._key, kq, ky, kp = jax.random.split(key, 4)
        U_pad, I, f = self._U_pad, self._num_items(), self.num_factors
        seen_i = np.zeros(I, dtype=bool)
        seen_i[self.ratings.items] = True
        q = self.init_mean + self.init_stdev * jax.random.normal(
            kq, (I, f), dtype=jnp.float32)
        y = self.init_mean + self.init_stdev * jax.random.normal(
            ky, (I, f), dtype=jnp.float32)
        q = jnp.where(jnp.asarray(seen_i)[:, None], q, 0.0)
        y = jnp.where(jnp.asarray(seen_i)[:, None], y, 0.0)
        self.params = dict(
            global_bias=jnp.float32(self._init_global_bias()),
            user_bias=jnp.zeros(U_pad, dtype=jnp.float32),
            item_bias=jnp.zeros(I, dtype=jnp.float32),
            item_factors=q, y=y)
        if self.USE_P:
            seen_u = np.zeros(U_pad, dtype=bool)
            seen_u[self.ratings.users] = True
            p = self.init_mean + self.init_stdev * jax.random.normal(
                kp, (U_pad, f), dtype=jnp.float32)
            self.params["p"] = jnp.where(jnp.asarray(seen_u)[:, None], p, 0.0)
        self.current_learnrate = self.learn_rate

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def iterate(self):
        self._user_factors_cache = None
        if getattr(self, "_mesh", None) is not None:
            self._iterate_sharded()
        else:
            self.params = svdpp_ops.svdpp_epoch(
                self.params, self._data, self._hp(),
                group_users=self._meta["group_users"],
                ngroups=self._meta["ngroups"],
                loss=_LOSS_ID[self.loss], sigmoid=self.SIGMOID,
                use_p=self.USE_P, update_user=self.update_users,
                update_item=self.update_items)
        self.current_learnrate *= self.learn_rate_decay

    def _iterate_sharded(self):
        """Mesh-sharded epoch: user slabs row-sharded over 'data', item
        tables replicated with per-group psum of deltas."""
        from mymedialite_tpu.parallel.mesh import (
            replicated, row_sharded, row_sharded_2d,
        )
        mesh = self._mesh
        rep = replicated(mesh)
        sh1, sh2 = row_sharded(mesh), row_sharded_2d(mesh)
        p = self.params
        params = dict(global_bias=jax.device_put(p["global_bias"], rep),
                      user_bias=jax.device_put(p["user_bias"], sh1),
                      item_bias=jax.device_put(p["item_bias"], rep),
                      item_factors=jax.device_put(p["item_factors"], rep),
                      y=jax.device_put(p["y"], rep))
        if self.USE_P:
            params["p"] = jax.device_put(p["p"], sh2)
        data = {k: jax.device_put(self._data[k], sh2)
                for k in ("r_user", "r_item", "r_value", "r_mask",
                          "e_user", "e_item", "e_mask")}
        data["inv_sqrt_hist"] = jax.device_put(
            self._data["inv_sqrt_hist"], sh1)
        hp = dict(self._hp())
        hp["user_reg"] = jax.device_put(hp["user_reg"], sh1)
        hp["item_reg"] = jax.device_put(hp["item_reg"], rep)
        hp["y_reg"] = jax.device_put(hp["y_reg"], rep)
        out = svdpp_ops.svdpp_epoch_sharded(
            mesh, params, data, hp,
            group_users=self._meta["group_users"],
            ngroups=self._meta["ngroups"], loss=_LOSS_ID[self.loss],
            sigmoid=self.SIGMOID, use_p=self.USE_P,
            update_user=self.update_users, update_item=self.update_items)
        # pull back to single-device arrays for the prediction paths
        self.params = {k: jnp.asarray(np.asarray(v))
                       for k, v in out.items()}

    # --- prediction (lazy PrecomputeUserFactors, SVDPlusPlus.cs:216-226) ---

    def _user_factors(self):
        if self._user_factors_cache is None:
            self._user_factors_cache = svdpp_ops.precompute_user_factors(
                self.params, self._data,
                group_users=self._meta["group_users"],
                ngroups=self._meta["ngroups"], use_p=self.USE_P)
        return self._user_factors_cache

    def _bound(self, score):
        return jnp.clip(score, self.min_rating, self.max_rating)

    def predict_batch(self, users, items):
        uf = self._user_factors()
        p = self.params
        U, I = self.num_users_trained, p["item_factors"].shape[0]
        u = jnp.asarray(users, dtype=jnp.int32)
        i = jnp.asarray(items, dtype=jnp.int32)
        uc = jnp.clip(u, 0, uf.shape[0] - 1)
        ic = jnp.clip(i, 0, I - 1)
        u_ok = (u >= 0) & (u < U)
        i_ok = (i >= 0) & (i < I)
        score = p["global_bias"] \
            + jnp.where(u_ok, p["user_bias"][uc], 0.0) \
            + jnp.where(i_ok, p["item_bias"][ic], 0.0) \
            + jnp.where(u_ok & i_ok,
                        jnp.sum(uf[uc] * p["item_factors"][ic], -1), 0.0)
        return np.asarray(self._bound(score))

    def catalog_scorer(self):
        if self.params is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        params = dict(uf=self._user_factors(),
                      item_factors=self._catalog_item_factors(),
                      global_bias=self.params["global_bias"],
                      user_bias=self.params["user_bias"],
                      item_bias=self.params["item_bias"],
                      min_rating=jnp.float32(self.min_rating),
                      max_rating=jnp.float32(self.max_rating))
        fn = _svdpp_catalog_sigmoid if self.SIGMOID else _svdpp_catalog_clip
        return fn, params

    def _catalog_item_factors(self):
        return self.params["item_factors"]

    def score_catalog(self, users):
        return np.asarray(self.score_catalog_device(users))

    def _retrain(self, users, items):
        """Incremental update: refresh layout and run one epoch over the
        affected users' groups (simplified RetrainUser semantics)."""
        if self.params is None:
            return
        old = self.params
        self._prepare()
        # grow arrays if needed
        U_pad, I, f = self._U_pad, self._num_items(), self.num_factors
        def grow(a, n):
            return jnp.concatenate([a, jnp.zeros((n - a.shape[0],) +
                                                 a.shape[1:])]) \
                if a.shape[0] < n else a
        old["user_bias"] = grow(old["user_bias"], U_pad)
        old["item_bias"] = grow(old["item_bias"], I)
        old["item_factors"] = grow(old["item_factors"], I)
        old["y"] = grow(old["y"], I)
        if self.USE_P:
            old["p"] = grow(old["p"], U_pad)
        self.params = old
        self._user_factors_cache = None
        self.iterate()

    # --- persistence (reference SVDPlusPlus.cs:272-311) ---

    def save_model(self, path):
        U = self.num_users_trained
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(float(self.params["global_bias"]))
            w.scalar(self.min_rating)
            w.scalar(self.max_rating)
            w.vector(np.asarray(self.params["user_bias"])[:U])
            w.vector(np.asarray(self.params["item_bias"]))
            w.matrix(np.asarray(self.params.get(
                "p", jnp.zeros((U, self.num_factors))))[:U])
            w.matrix(np.asarray(self.params["y"]))
            w.matrix(np.asarray(self.params["item_factors"]))

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            gb = r.scalar()
            self.min_rating = r.scalar()
            self.max_rating = r.scalar()
            bu = r.vector()
            bi = r.vector()
            p = r.matrix()
            y = r.matrix()
            q = r.matrix()
        self.num_factors = q.shape[1]
        self._prepare()
        U_pad = self._U_pad
        self.params = dict(
            global_bias=jnp.float32(gb),
            user_bias=jnp.asarray(np.pad(bu, (0, U_pad - bu.shape[0]))),
            item_bias=jnp.asarray(bi),
            item_factors=jnp.asarray(q),
            y=jnp.asarray(y))
        if self.USE_P:
            self.params["p"] = jnp.asarray(
                np.pad(p, ((0, U_pad - p.shape[0]), (0, 0))))
        self.current_learnrate = self.learn_rate
        self._key = jax.random.PRNGKey(self.random_seed)
        self._user_factors_cache = None


class SigmoidSVDPlusPlus(SVDPlusPlus):
    """SVD++ with sigmoid bounding + selectable loss
    (reference SigmoidSVDPlusPlus.cs:42)."""

    HYPERPARAMS = dict(SVDPlusPlus.HYPERPARAMS, loss=OptimizationTarget)
    SIGMOID = True

    def __init__(self):
        super().__init__()
        # reference SigmoidSVDPlusPlus defaults
        self.learn_rate = 0.001
        self.bias_learn_rate = 0.7
        self.bias_reg = 0.33

    def _init_global_bias(self):
        import math
        rng = max(self.max_rating - self.min_rating, 1e-9)
        avg = (self.ratings.average - self.min_rating) / rng
        avg = min(max(avg, 1e-6), 1 - 1e-6)
        return math.log(avg / (1 - avg))

    def _bound(self, score):
        rng = max(self.max_rating - self.min_rating, 1e-9)
        return self.min_rating + jax.nn.sigmoid(score) * rng


class SigmoidItemAsymmetricFactorModel(SigmoidSVDPlusPlus):
    """AFM: user expressed purely by rated items — no p matrix
    (reference SigmoidItemAsymmetricFactorModel.cs:29)."""
    USE_P = False


class SigmoidUserAsymmetricFactorModel(SigmoidSVDPlusPlus):
    """Mirrored AFM: items expressed by their raters
    (reference SigmoidUserAsymmetricFactorModel.cs:43). Implemented by
    training the item-AFM on the transposed rating matrix."""
    USE_P = False

    def __init__(self):
        super().__init__()
        self._transposed = True

    @property
    def ratings(self):
        return self._orig_ratings

    @ratings.setter
    def ratings(self, data):
        self._orig_ratings = data
        if data is not None:
            from mymedialite_tpu.data.arrays import RatingData
            self._ratings_t = RatingData(
                data.items, data.users, data.values,
                num_users=data.num_items, num_items=data.num_users,
                scale=data.scale)
            self.min_rating = data.scale.min
            self.max_rating = data.scale.max
            self.num_users_trained = data.num_users
            self.num_items_trained = data.num_items
        else:
            self._ratings_t = None

    def train(self):
        inner = SigmoidItemAsymmetricFactorModel()
        for name in list(self.HYPERPARAMS) + list(self.EXTRA_PARAMS):
            if hasattr(self, name) and hasattr(inner, name):
                setattr(inner, name, getattr(self, name))
        inner.random_seed = self.random_seed
        inner.ratings = self._ratings_t
        if self.additional_feedback is not None:
            au, ai = self.additional_feedback
            inner.additional_feedback = (ai, au)
        inner.train()
        self._inner = inner

    def iterate(self):
        self._inner.iterate()

    def predict_batch(self, users, items):
        return self._inner.predict_batch(items, users)

    def catalog_scorer(self):
        # role swap: original users index the inner model's item axis,
        # the catalog axis is the inner model's (real) users
        inner = self._inner
        ip = inner.params
        nI = inner.num_users_trained
        params = dict(uf=ip["item_factors"],
                      item_factors=inner._user_factors()[:nI],
                      user_bias=ip["item_bias"],
                      item_bias=ip["user_bias"][:nI],
                      global_bias=ip["global_bias"],
                      min_rating=jnp.float32(self.min_rating),
                      max_rating=jnp.float32(self.max_rating))
        return _svdpp_catalog_sigmoid, params

    def score_catalog(self, users):
        return np.asarray(self.score_catalog_device(users))

    def save_model(self, path):
        self._inner.save_model(path)
        # rewrite header with this class's name
        with open(path) as f:
            lines = f.readlines()
        lines[0] = type(self).__name__ + "\n"
        with open(path, "w") as f:
            f.writelines(lines)

    def load_model(self, path):
        inner = SigmoidItemAsymmetricFactorModel()
        with open(path) as f:
            lines = f.readlines()
        lines[0] = "SigmoidItemAsymmetricFactorModel\n"
        import tempfile
        with tempfile.NamedTemporaryFile("w", suffix=".model",
                                         delete=False) as tmp:
            tmp.writelines(lines)
            tmp_path = tmp.name
        inner.ratings = self._ratings_t
        inner.load_model(tmp_path)
        self._inner = inner

    def _retrain(self, users, items):
        if getattr(self, "_inner", None) is None:
            return
        self._inner.ratings = self._ratings_t
        self._inner._retrain(items, users)


class SigmoidCombinedAsymmetricFactorModel(SigmoidSVDPlusPlus):
    """Both AFM directions combined
    (reference SigmoidCombinedAsymmetricFactorModel.cs): the score is the
    average of the item-AFM and user-AFM scores."""
    USE_P = False

    def train(self):
        self._item_afm = SigmoidItemAsymmetricFactorModel()
        self._user_afm = SigmoidUserAsymmetricFactorModel()
        for inner in (self._item_afm, self._user_afm):
            for name in list(self.HYPERPARAMS) + list(self.EXTRA_PARAMS):
                if hasattr(self, name) and hasattr(inner, name):
                    setattr(inner, name, getattr(self, name))
            inner.random_seed = self.random_seed
            inner.ratings = self.ratings
            inner.additional_feedback = self.additional_feedback
            inner.train()

    def iterate(self):
        self._item_afm.iterate()
        self._user_afm.iterate()

    def predict_batch(self, users, items):
        return 0.5 * (self._item_afm.predict_batch(users, items)
                      + self._user_afm.predict_batch(users, items))

    def catalog_scorer(self):
        _, pa = self._item_afm.catalog_scorer()
        _, pb = self._user_afm.catalog_scorer()
        return _svdpp_catalog_combined, {"item": pa, "user": pb}

    def score_catalog(self, users):
        return np.asarray(self.score_catalog_device(users))

    def save_model(self, path):
        self._item_afm.save_model(path + "-item")
        self._user_afm.save_model(path + "-user")
        with open(path, "w") as f:
            f.write(f"{type(self).__name__}\n2.99\ncombined\n")

    def load_model(self, path):
        self._item_afm = SigmoidItemAsymmetricFactorModel()
        self._item_afm.ratings = self.ratings
        self._item_afm.load_model(path + "-item")
        self._user_afm = SigmoidUserAsymmetricFactorModel()
        self._user_afm.ratings = self.ratings
        self._user_afm.load_model(path + "-user")


class GSVDPlusPlus(SVDPlusPlus):
    """gSVD++ (reference GSVDPlusPlus.cs:29-243, Manzato SAC 2013):
    SVD++ whose effective item factor is q_i plus the mean of the item's
    attribute factors x_a."""

    REQUIRED_SIDE_INFO = ("item_attributes",)
    SHARDABLE = False  # attribute-factor updates stay single-device

    def __init__(self):
        super().__init__()
        self.item_attributes = None  # InteractionData: item -> attribute

    def _prepare(self):
        super()._prepare()
        if self.item_attributes is None:
            raise ValueError("GSVDPlusPlus needs item attributes")
        I = self._num_items()
        n_attr = self.item_attributes.num_items
        A = np.zeros((I, n_attr), dtype=np.float32)
        au = np.asarray(self.item_attributes.users)
        aa = np.asarray(self.item_attributes.items)
        keep = au < I
        A[au[keep], aa[keep]] = 1.0
        counts = A.sum(axis=1, keepdims=True)
        A_norm = np.divide(A, counts, out=np.zeros_like(A), where=counts > 0)
        self._data["attr_norm"] = jnp.asarray(A_norm)
        # x_reg: reg / column count if frequency regularization
        # (GSVDPlusPlus.cs:90-94 — note: count, not sqrt)
        col = np.maximum(A.sum(axis=0), 1.0)
        reg = self.regularization
        x_reg = (reg / col if self.frequency_regularization
                 else np.full(n_attr, reg)).astype(np.float32)
        self._hp_arrays["x_reg"] = jnp.asarray(x_reg)
        self._n_attr = n_attr

    def init_model(self):
        super().init_model()
        self._key, kx = jax.random.split(self._key)
        self.params["x"] = self.init_mean + self.init_stdev * \
            jax.random.normal(kx, (self._n_attr, self.num_factors),
                              dtype=jnp.float32)

    def iterate(self):
        self._user_factors_cache = None
        self._item_factors_cache = None
        self.params = svdpp_ops.svdpp_epoch(
            self.params, self._data, self._hp(),
            group_users=self._meta["group_users"],
            ngroups=self._meta["ngroups"],
            loss=_LOSS_ID[self.loss], sigmoid=self.SIGMOID,
            use_p=self.USE_P, update_user=self.update_users,
            update_item=self.update_items, use_attrs=True)
        self.current_learnrate *= self.learn_rate_decay

    def _effective_item_factors(self):
        if getattr(self, "_item_factors_cache", None) is None:
            self._item_factors_cache = self.params["item_factors"] + \
                self._data["attr_norm"] @ self.params["x"]
        return self._item_factors_cache

    def predict_batch(self, users, items):
        uf = self._user_factors()
        p = self.params
        q_eff = self._effective_item_factors()
        U, I = self.num_users_trained, q_eff.shape[0]
        u = jnp.asarray(users, dtype=jnp.int32)
        i = jnp.asarray(items, dtype=jnp.int32)
        uc = jnp.clip(u, 0, uf.shape[0] - 1)
        ic = jnp.clip(i, 0, I - 1)
        u_ok = (u >= 0) & (u < U)
        i_ok = (i >= 0) & (i < I)
        score = p["global_bias"] \
            + jnp.where(u_ok, p["user_bias"][uc], 0.0) \
            + jnp.where(i_ok, p["item_bias"][ic], 0.0) \
            + jnp.where(u_ok & i_ok, jnp.sum(uf[uc] * q_eff[ic], -1), 0.0)
        return np.asarray(self._bound(score))

    def _catalog_item_factors(self):
        return self._effective_item_factors()

    def save_model(self, path):
        U = self.num_users_trained
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(float(self.params["global_bias"]))
            w.scalar(self.min_rating)
            w.scalar(self.max_rating)
            w.vector(np.asarray(self.params["user_bias"])[:U])
            w.vector(np.asarray(self.params["item_bias"]))
            w.matrix(np.asarray(self.params["p"])[:U])
            w.matrix(np.asarray(self.params["y"]))
            w.matrix(np.asarray(self.params["item_factors"]))
            w.matrix(np.asarray(self.params["x"]))

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            gb = r.scalar()
            self.min_rating = r.scalar()
            self.max_rating = r.scalar()
            bu = r.vector()
            bi = r.vector()
            p = r.matrix()
            y = r.matrix()
            q = r.matrix()
            x = r.matrix()
        self.num_factors = q.shape[1]
        self._prepare()
        U_pad = self._U_pad
        self.params = dict(
            global_bias=jnp.float32(gb),
            user_bias=jnp.asarray(np.pad(bu, (0, U_pad - bu.shape[0]))),
            item_bias=jnp.asarray(bi),
            item_factors=jnp.asarray(q), y=jnp.asarray(y),
            p=jnp.asarray(np.pad(p, ((0, U_pad - p.shape[0]), (0, 0)))),
            x=jnp.asarray(x))
        self.current_learnrate = self.learn_rate
        self._key = jax.random.PRNGKey(self.random_seed)
        self._user_factors_cache = None
        self._item_factors_cache = None
