"""Time-aware baseline rating predictors (Koren TKDD 2009).

JAX counterparts of reference
``RatingPrediction/TimeAwareBaseline.cs:44`` (time-binned item bias,
user drift alpha*dev_u(t), per-day user bias, user scaling c_u + c_ut)
and ``TimeAwareBaselineWithFrequencies.cs:42`` (+ log-frequency item
bias). The per-rating SGD becomes jitted minibatch scatter-add epochs;
the reference's sparse per-day matrices become dense [U, num_days] /
[I, num_bins] device arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu.models.base import IterativeModel, RatingPredictor

SECONDS_PER_DAY = 86_400


class TimeAwareBaseline(RatingPredictor, IterativeModel):
    HYPERPARAMS = {
        "num_iter": int,
        "bin_size": int,
        "beta": float,
        "user_bias_learn_rate": float,
        "item_bias_learn_rate": float,
        "alpha_learn_rate": float,
        "item_bias_by_time_bin_learn_rate": float,
        "user_bias_by_day_learn_rate": float,
        "user_scaling_learn_rate": float,
        "user_scaling_by_day_learn_rate": float,
        "reg_u": float,
        "reg_i": float,
        "reg_alpha": float,
        "reg_item_bias_by_time_bin": float,
        "reg_user_bias_by_day": float,
        "reg_user_scaling": float,
        "reg_user_scaling_by_day": float,
    }
    EXTRA_PARAMS = {"batch_size": int}

    time_aware = True
    WITH_FREQUENCIES = False

    def __init__(self):
        super().__init__()
        # defaults per reference TimeAwareBaseline.cs:118-143
        self.num_iter = 30
        self.bin_size = 70
        self.beta = 0.4
        self.user_bias_learn_rate = 0.003
        self.item_bias_learn_rate = 0.002
        self.alpha_learn_rate = 0.00001
        self.item_bias_by_time_bin_learn_rate = 0.000005
        self.user_bias_by_day_learn_rate = 0.0025
        self.user_scaling_learn_rate = 0.008
        self.user_scaling_by_day_learn_rate = 0.002
        self.reg_u = 0.03
        self.reg_i = 0.03
        self.reg_alpha = 50.0
        self.reg_item_bias_by_time_bin = 0.1
        self.reg_user_bias_by_day = 0.005
        self.reg_user_scaling = 0.01
        self.reg_user_scaling_by_day = 0.005
        self.batch_size = 65_536
        self.random_seed = 42
        self.params = None

    def _relative_day(self, times):
        return ((np.asarray(times, dtype=np.int64) - self._earliest)
                // SECONDS_PER_DAY).astype(np.int32)

    def train(self):
        data = self.ratings
        if data.times is None:
            raise ValueError("TimeAwareBaseline requires timed ratings")
        self._earliest = int(data.times.min())
        days = self._relative_day(data.times)
        self._num_days = int(days.max()) + 1
        self._latest_day = int(days.max())
        self._num_bins = (self._num_days - 1) // self.bin_size + 1
        U, I = data.num_users, data.num_items

        # mean rating day per user (reference Train :150-160)
        sums = np.zeros(U)
        np.add.at(sums, data.users, days)
        cu = np.maximum(data.count_by_user, 1)
        mean_day = sums / cu
        mean_day[data.count_by_user == 0] = self._latest_day
        self._user_mean_day = mean_day.astype(np.float32)

        self.global_average = float(data.average)
        self.params = dict(
            user_bias=jnp.zeros(U), item_bias=jnp.zeros(I),
            alpha=jnp.zeros(U),
            item_bias_by_time_bin=jnp.zeros((I, self._num_bins)),
            user_bias_by_day=jnp.zeros((U, self._num_days)),
            user_scaling=jnp.ones(U),
            user_scaling_by_day=jnp.zeros((U, self._num_days)),
        )
        self._prepare_epoch()
        for _ in range(self.num_iter):
            self.iterate()

    def _prepare_epoch(self):
        """Build the padded shuffled epoch arrays from ``self.ratings``.
        Called by ``train()`` and lazily by ``iterate()`` after
        ``load_model`` (reference Train/Iterate split)."""
        data = self.ratings
        if data is None or data.times is None:
            raise RuntimeError(f"{type(self).__name__}: timed ratings must "
                               "be set before iterating")
        days = self._relative_day(data.times)
        # dev_u(t) precomputed per rating (constant during training)
        diff = days - self._user_mean_day[data.users]
        dev = np.sign(diff) * np.abs(diff) ** self.beta

        n = len(data)
        perm = np.random.default_rng(self.random_seed).permutation(n)
        B = min(self.batch_size, max(n, 1))
        n_pad = ((n + B - 1) // B) * B
        def pad(a, dtype):
            return jnp.asarray(np.concatenate(
                [np.asarray(a, dtype)[perm],
                 np.zeros(n_pad - n, dtype)]))
        self._epoch = dict(
            users=pad(data.users, np.int32), items=pad(data.items, np.int32),
            values=pad(data.values, np.float32),
            days=pad(np.minimum(days, self._num_days - 1), np.int32),
            bins=pad(np.minimum(days // self.bin_size, self._num_bins - 1),
                     np.int32),
            dev=pad(dev, np.float32),
            weights=jnp.asarray(np.concatenate(
                [np.ones(n, np.float32), np.zeros(n_pad - n, np.float32)])),
        )
        if self.WITH_FREQUENCIES:
            self._setup_frequencies(days)
        self._B = B
        self._key = jax.random.PRNGKey(self.random_seed)

    def _setup_frequencies(self, days):
        data = self.ratings
        U = data.num_users
        # log-frequency of ratings per (user, day)
        # (reference TimeAwareBaselineWithFrequencies.Train :90-106)
        key = data.users.astype(np.int64) * self._num_days + days
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        logf = np.ceil(np.log(np.maximum(counts, 1)) /
                       np.log(self.frequency_log_base)).astype(np.int32)
        freq_by_day = np.zeros((U, self._num_days), dtype=np.int32)
        freq_by_day[uniq // self._num_days, uniq % self._num_days] = logf
        self._freq_by_day = freq_by_day
        self._num_freqs = max(int(logf.max()) + 1, 1)
        if "item_bias_at_frequency" in self.params:
            # loaded model: keep the trained table, growing it if the
            # current data has higher frequencies than the saved one
            tbl = self.params["item_bias_at_frequency"]
            if tbl.shape[1] < self._num_freqs:
                tbl = jnp.pad(tbl, ((0, 0),
                                    (0, self._num_freqs - tbl.shape[1])))
            self._num_freqs = int(tbl.shape[1])
            self.params["item_bias_at_frequency"] = tbl
        else:
            self.params["item_bias_at_frequency"] = jnp.zeros(
                (data.num_items, self._num_freqs))
        per_rating_freq = logf[inv]
        n_pad = self._epoch["users"].shape[0]
        n = len(data)
        perm = np.random.default_rng(self.random_seed).permutation(n)
        self._epoch["freqs"] = jnp.asarray(np.concatenate(
            [per_rating_freq[perm], np.zeros(n_pad - n, np.int32)]))

    def _hp(self):
        names = [k for k in self.HYPERPARAMS if k not in ("num_iter",
                                                          "bin_size")]
        hp = {k: jnp.float32(getattr(self, k)) for k in names}
        hp["global_average"] = jnp.float32(self.global_average)
        if self.WITH_FREQUENCIES:
            hp["item_bias_at_frequency_learn_rate"] = jnp.float32(
                self.item_bias_at_frequency_learn_rate)
            hp["reg_item_bias_at_frequency"] = jnp.float32(
                self.reg_item_bias_at_frequency)
        return hp

    def iterate(self):
        if getattr(self, "_epoch", None) is None:
            self._prepare_epoch()     # load_model -> keep iterating
        self._key, sub = jax.random.split(self._key)
        self.params = _time_aware_epoch(
            self.params, self._epoch, sub, self._hp(),
            batch_size=self._B, with_freq=self.WITH_FREQUENCIES)

    # --- prediction ---

    def predict_batch(self, users, items):
        """Without time: mu + b_u + b_i (reference Predict(u,i) :233-243)."""
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        p = self.params
        bu = np.asarray(p["user_bias"])
        bi = np.asarray(p["item_bias"])
        out = np.full(users.shape, self.global_average, dtype=np.float32)
        ok_u = (users >= 0) & (users < bu.shape[0])
        ok_i = (items >= 0) & (items < bi.shape[0])
        out[ok_u] += bu[users[ok_u]]
        out[ok_i] += bi[items[ok_i]]
        return out

    def predict_batch_time(self, users, items, times):
        """Full time-aware prediction (reference Predict(u,i,t) :264-295)."""
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        days = self._relative_day(times)
        bins = np.minimum(days // self.bin_size, self._num_bins - 1)
        p = {k: np.asarray(v) for k, v in self.params.items()}
        U, I = p["user_bias"].shape[0], p["item_bias"].shape[0]
        out = np.full(users.shape, self.global_average, dtype=np.float64)
        scaling = np.ones(users.shape, dtype=np.float64)
        ok_u = (users >= 0) & (users < U)
        uu = users[ok_u]
        diff = days[ok_u] - self._user_mean_day[uu]
        dev = np.sign(diff) * np.abs(diff) ** self.beta
        out[ok_u] += p["user_bias"][uu] + p["alpha"][uu] * dev
        in_days = ok_u & (days >= 0) & (days <= self._latest_day)
        out[in_days] += p["user_bias_by_day"][users[in_days], days[in_days]]
        scaling[ok_u] = p["user_scaling"][uu]
        scaling[in_days] += p["user_scaling_by_day"][users[in_days],
                                                     days[in_days]]
        ok_i = (items >= 0) & (items < I)
        item_term = np.zeros(users.shape, dtype=np.float64)
        item_term[ok_i] = p["item_bias"][items[ok_i]] + \
            p["item_bias_by_time_bin"][items[ok_i],
                                       np.maximum(bins[ok_i], 0)]
        out += item_term * scaling
        if self.WITH_FREQUENCIES:
            both = ok_u & ok_i & (days >= 0) & (days <= self._latest_day)
            f = self._freq_by_day[users[both], days[both]]
            out[both] += p["item_bias_at_frequency"][items[both], f]
        return out.astype(np.float32)

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            self._write_sections(w)

    def _write_sections(self, w):
        p = self.params
        w.scalar(self.global_average)
        w.int_scalar(self._earliest)
        w.int_scalar(self._latest_day)
        w.int_scalar(self._num_bins)
        w.vector(np.asarray(p["user_bias"]))
        w.vector(np.asarray(p["item_bias"]))
        w.vector(np.asarray(p["alpha"]))
        w.vector(self._user_mean_day)
        w.matrix(np.asarray(p["item_bias_by_time_bin"]))
        w.matrix(np.asarray(p["user_bias_by_day"]))
        w.vector(np.asarray(p["user_scaling"]))
        w.matrix(np.asarray(p["user_scaling_by_day"]))

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self._read_sections(r)

    def _read_sections(self, r):
        self.global_average = r.scalar()
        self._earliest = r.int_scalar()
        self._latest_day = r.int_scalar()
        self._num_bins = r.int_scalar()
        bu = r.vector()
        bi = r.vector()
        alpha = r.vector()
        self._user_mean_day = r.vector()
        ibt = r.matrix()
        ubd = r.matrix()
        us = r.vector()
        usd = r.matrix()
        self._num_days = ubd.shape[1]
        self.params = dict(
            user_bias=jnp.asarray(bu), item_bias=jnp.asarray(bi),
            alpha=jnp.asarray(alpha),
            item_bias_by_time_bin=jnp.asarray(ibt),
            user_bias_by_day=jnp.asarray(ubd),
            user_scaling=jnp.asarray(us),
            user_scaling_by_day=jnp.asarray(usd))
        self.num_users_trained = bu.shape[0]
        self.num_items_trained = bi.shape[0]
        self._epoch = None            # rebuilt lazily on iterate()


class TimeAwareBaselineWithFrequencies(TimeAwareBaseline):
    HYPERPARAMS = dict(
        TimeAwareBaseline.HYPERPARAMS,
        frequency_log_base=float,
        item_bias_at_frequency_learn_rate=float,
        reg_item_bias_at_frequency=float,
    )

    WITH_FREQUENCIES = True

    def __init__(self):
        super().__init__()
        # defaults per reference TimeAwareBaselineWithFrequencies.cs:63-87
        self.num_iter = 40
        self.frequency_log_base = 6.76
        self.user_bias_learn_rate = 0.00267
        self.item_bias_learn_rate = 0.000488
        self.alpha_learn_rate = 0.00000311
        self.item_bias_by_time_bin_learn_rate = 0.000115
        self.user_bias_by_day_learn_rate = 0.000257
        self.user_scaling_learn_rate = 0.00564
        self.user_scaling_by_day_learn_rate = 0.00103
        self.item_bias_at_frequency_learn_rate = 0.00236
        self.reg_u = 0.0255
        self.reg_i = 0.0255
        self.reg_alpha = 3.95
        self.reg_item_bias_by_time_bin = 0.0929
        self.reg_user_bias_by_day = 0.00231
        self.reg_user_scaling = 0.0476
        self.reg_user_scaling_by_day = 0.019
        self.reg_item_bias_at_frequency = 0.000000011

    # persistence: the base sections plus the frequency structures
    # (reference TimeAwareBaselineWithFrequencies.cs:42 SaveModel writes
    # item_bias_at_frequency and the per-(user,day) log-frequency matrix)

    def _write_sections(self, w):
        super()._write_sections(w)
        w.matrix(np.asarray(self.params["item_bias_at_frequency"]))
        fb = self._freq_by_day
        uu, dd = np.nonzero(fb)
        w.sparse(fb.shape[0], fb.shape[1], uu, dd,
                 fb[uu, dd].astype(np.float32))

    def _read_sections(self, r):
        super()._read_sections(r)
        biaf = r.matrix()
        rows, cols, uu, dd, vv = r.sparse()
        self.params["item_bias_at_frequency"] = jnp.asarray(biaf)
        self._num_freqs = biaf.shape[1]
        fb = np.zeros((rows, cols), dtype=np.int32)
        fb[uu, dd] = vv.astype(np.int32)
        self._freq_by_day = fb


@functools.partial(jax.jit, static_argnames=("batch_size", "with_freq"),
                   donate_argnames=("params",))
def _time_aware_epoch(params, data, key, hp, *, batch_size: int,
                      with_freq: bool):
    """Minibatched SGD epoch over timed ratings (reference
    TimeAwareBaseline.Iterate + UpdateParameters :196-236)."""
    n_pad = data["users"].shape[0]
    nb = n_pad // batch_size
    order = jax.random.permutation(key, nb)

    def step(p, b):
        start = order[b] * batch_size

        def sl(name):
            return jax.lax.dynamic_slice(data[name], (start,), (batch_size,))

        u, i, v, w = sl("users"), sl("items"), sl("values"), sl("weights")
        day, bin_, dev = sl("days"), sl("bins"), sl("dev")

        bu = p["user_bias"][u]
        bi = p["item_bias"][i]
        al = p["alpha"][u]
        bib = p["item_bias_by_time_bin"][i, bin_]
        bud = p["user_bias_by_day"][u, day]
        cu = p["user_scaling"][u]
        cud = p["user_scaling_by_day"][u, day]

        pred = hp["global_average"] + bu + al * dev + bud + \
            (bi + bib) * (cu + cud)
        if with_freq:
            f = sl("freqs")
            biaf = p["item_bias_at_frequency"][i, f]
            pred = pred + biaf
        err = (v - pred) * w

        p["alpha"] = p["alpha"].at[u].add(
            hp["alpha_learn_rate"] * (err * dev - hp["reg_alpha"] * w * al))
        p["user_bias"] = p["user_bias"].at[u].add(
            hp["user_bias_learn_rate"] * (err - hp["reg_u"] * w * bu))
        p["user_bias_by_day"] = p["user_bias_by_day"].at[u, day].add(
            hp["user_bias_by_day_learn_rate"] *
            (err - hp["reg_user_bias_by_day"] * w * bud))
        p["item_bias"] = p["item_bias"].at[i].add(
            hp["item_bias_learn_rate"] *
            (err * (cu + cud) - hp["reg_i"] * w * bi))
        p["item_bias_by_time_bin"] = \
            p["item_bias_by_time_bin"].at[i, bin_].add(
                hp["item_bias_by_time_bin_learn_rate"] *
                (err * (cu + cud) - hp["reg_item_bias_by_time_bin"] * w * bib))
        p["user_scaling"] = p["user_scaling"].at[u].add(
            hp["user_scaling_learn_rate"] *
            (err * (bi + bib) - hp["reg_user_scaling"] * w * (cu - 1.0)))
        p["user_scaling_by_day"] = \
            p["user_scaling_by_day"].at[u, day].add(
                hp["user_scaling_by_day_learn_rate"] *
                (err * (bi + bib) - hp["reg_user_scaling_by_day"] * w * cud))
        if with_freq:
            # reference update: err * b_{i,f} - reg * b_{i,f}
            p["item_bias_at_frequency"] = \
                p["item_bias_at_frequency"].at[i, f].add(
                    hp["item_bias_at_frequency_learn_rate"] *
                    (err * biaf - hp["reg_item_bias_at_frequency"] * w * biaf))
        return p, None

    params, _ = jax.lax.scan(step, params, jnp.arange(nb, dtype=jnp.int32))
    return params
