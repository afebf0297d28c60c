"""The XLA training epochs against sequential numpy oracles.

At batch size 1 a minibatch epoch applies one update at a time, so it
must equal the reference's sequential per-example rule applied in the
epoch's visit order (reference MatrixFactorization.cs:166-196,
BiasedMatrixFactorization.cs:264-309, BPRMF.cs:330-374,
SoftMarginRankingMF.cs:52-110). The visit order and the sampled triples
are inputs here: the samplers have their own tests
(test_bpr_sampling.py). SVD++ is checked against its grouped-epoch rule
(ops/svdpp.py) with one user per group.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mymedialite_tpu.data import PosOnlyData, RatingData
from mymedialite_tpu.ops import bpr as bpr_ops
from mymedialite_tpu.ops import sgd

LR, REG_U, REG_I, BIAS_LR, BIAS_REG = 0.05, 0.02, 0.03, 0.7, 0.1
MIN_R, RANGE = 1.0, 4.0


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _grad(loss, err, sig, rating_range=RANGE):
    if loss == sgd.LOSS_RMSE:
        return err * sig * (1 - sig) * rating_range
    if loss == sgd.LOSS_MAE:
        return np.sign(err) * sig * (1 - sig) * rating_range
    return err


def _mf_step(W, H, bu, bi, u, i, v, *, gb, biased, loss, reg_u, reg_i,
             update_user=True, update_item=True):
    """One reference SGD update of rating (u, i, v), in place."""
    wu, hi = W[u].copy(), H[i].copy()
    if biased:
        sig = _sigmoid(gb + bu[u] + bi[i] + wu @ hi)
        g = _grad(loss, v - (MIN_R + sig * RANGE), sig)
    else:
        g = v - (gb + wu @ hi)
    if update_user:
        W[u] += LR * (g * hi - reg_u * wu)
        if biased:
            bu[u] += BIAS_LR * LR * (g - BIAS_REG * reg_u * bu[u])
    if update_item:
        H[i] += LR * (g * wu - reg_i * hi)
        if biased:
            bi[i] += BIAS_LR * LR * (g - BIAS_REG * reg_i * bi[i])


def _ratings(seed=0, U=12, I=9, n=60):
    rng = np.random.default_rng(seed)
    keys = rng.choice(U * I, n, replace=False)
    users, items = (keys // I).astype(np.int32), (keys % I).astype(np.int32)
    values = (np.round(rng.uniform(1, 5, n) * 2) / 2).astype(np.float32)
    return users, items, values


def _tables(seed, U, I, f):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (U, f)), rng.normal(0, 0.1, (I, f)),
            rng.normal(0, 0.1, U), rng.normal(0, 0.1, I))


def _inv_sqrt_counts(ids, n):
    return 1.0 / np.sqrt(np.maximum(np.bincount(ids, minlength=n), 1.0))


MF_CASES = [
    # (biased, loss, frequency_regularization, update_user, update_item)
    (False, sgd.LOSS_RMSE, False, True, True),
    (False, sgd.LOSS_RMSE, True, True, True),
    (True, sgd.LOSS_RMSE, False, True, True),
    (True, sgd.LOSS_RMSE, True, True, True),
    (True, sgd.LOSS_MAE, False, True, True),
    (True, sgd.LOSS_MAE, True, True, True),
    (True, sgd.LOSS_LOGISTIC, False, True, True),
    (True, sgd.LOSS_LOGISTIC, True, True, True),
    (True, sgd.LOSS_RMSE, False, False, True),
    (True, sgd.LOSS_RMSE, False, True, False),
]


class TestBlockedSGDEpoch:
    """ops/sgd.py sgd_epoch_blocked: groups in id order, batches in a
    per-group permutation of fold_in(key, group)."""

    @pytest.mark.parametrize("biased,loss,freq,upd_u,upd_i", MF_CASES)
    def test_batch_one_equals_sequential_rule(self, biased, loss, freq,
                                              upd_u, upd_i):
        U, I, f, G = 12, 9, 3, 4
        users, items, values = _ratings()
        W0, H0, bu0, bi0 = _tables(1, U, I, f)
        if not biased:
            bu0, bi0 = np.zeros(U), np.zeros(I)
        gb = 0.3
        data, meta = sgd.prepare_blocked_data(users, items, values, U,
                                              batch_size=1, group_users=G,
                                              shuffle_seed=3)
        W, H = sgd.extend_tables(W0, H0, bu0, bi0, group_users=G)
        inv_u = _inv_sqrt_counts(users, W.shape[0])
        inv_i = _inv_sqrt_counts(items, I)
        freq_arrays = ((jnp.asarray(inv_u, jnp.float32),
                        jnp.asarray(inv_i, jnp.float32)) if freq
                       else (jnp.zeros(0), jnp.zeros(0)))
        key = jax.random.PRNGKey(5)
        hp = dict(global_bias=jnp.float32(gb), min_rating=jnp.float32(MIN_R),
                  rating_range=jnp.float32(RANGE))
        rates = sgd.column_rates(f, LR, REG_U, REG_I, BIAS_LR, BIAS_REG,
                                 biased, upd_u, upd_i)
        Wn, Hn = sgd.sgd_epoch_blocked(
            W, H, data, key, hp, rates, freq_arrays,
            meta=tuple(sorted(meta.items())), loss=loss, biased=biased,
            frequency_regularization=freq)
        got = sgd.split_tables(Wn, Hn, U)

        W, H, bu, bi = W0.copy(), H0.copy(), bu0.copy(), bi0.copy()
        gu, gi = np.asarray(data["gu"]), np.asarray(data["gi"])
        gv, gw = np.asarray(data["gv"]), np.asarray(data["gw"])
        for g in range(meta["ngroups"]):
            order = np.asarray(jax.random.permutation(
                jax.random.fold_in(key, g), meta["l_pad"]))
            for b in order:
                if gw[g, b] == 0:
                    continue
                u = int(gu[g, b]) + g * G
                i = int(gi[g, b])
                _mf_step(W, H, bu, bi, u, i, float(gv[g, b]), gb=gb,
                         biased=biased, loss=loss,
                         reg_u=REG_U * (inv_u[u] if freq else 1.0),
                         reg_i=REG_I * (inv_i[i] if freq else 1.0),
                         update_user=upd_u, update_item=upd_i)
        for name, x, y in zip(("W", "H", "b_u", "b_i"), got, (W, H, bu, bi)):
            np.testing.assert_allclose(x, y, atol=2e-5, err_msg=name)


class TestFlatSGDEpoch:
    """ops/sgd.py sgd_epoch (the flat, SPMD-partitioned epoch): batches
    visited in permutation(key) order over the unshuffled stream."""

    @pytest.mark.parametrize("biased,loss,freq", [
        (False, sgd.LOSS_RMSE, False),
        (True, sgd.LOSS_RMSE, False),
        (True, sgd.LOSS_MAE, False),
        (True, sgd.LOSS_LOGISTIC, False),
        (True, sgd.LOSS_RMSE, True),
    ])
    def test_batch_one_equals_sequential_rule(self, biased, loss, freq):
        U, I, f = 12, 9, 3
        users, items, values = _ratings(seed=4)
        W0, H0, bu0, bi0 = _tables(2, U, I, f)
        gb = 0.2
        data = sgd.prepare_epoch_data(users, items, values, 1,
                                      shuffle_seed=None, num_users=U,
                                      num_items=I)
        inv_u, inv_i = _inv_sqrt_counts(users, U), _inv_sqrt_counts(items, I)
        if freq:
            data = dict(data,
                        inv_sqrt_count_user=jnp.asarray(inv_u, jnp.float32),
                        inv_sqrt_count_item=jnp.asarray(inv_i, jnp.float32))
        params = dict(global_bias=jnp.float32(gb),
                      user_factors=jnp.asarray(W0, jnp.float32),
                      item_factors=jnp.asarray(H0, jnp.float32))
        if biased:
            params.update(user_bias=jnp.asarray(bu0, jnp.float32),
                          item_bias=jnp.asarray(bi0, jnp.float32))
        hp = {k: jnp.float32(v) for k, v in dict(
            learn_rate=LR, reg_u=REG_U, reg_i=REG_I, bias_reg=BIAS_REG,
            bias_learn_rate=BIAS_LR, min_rating=MIN_R,
            rating_range=RANGE).items()}
        key = jax.random.PRNGKey(9)
        out = sgd.sgd_epoch(params, data, key, hp, batch_size=1, loss=loss,
                            biased=biased, update_user=True,
                            update_item=True, frequency_regularization=freq)

        W, H, bu, bi = W0.copy(), H0.copy(), bu0.copy(), bi0.copy()
        for b in np.asarray(jax.random.permutation(key, len(users))):
            u, i = int(users[b]), int(items[b])
            _mf_step(W, H, bu, bi, u, i, float(values[b]), gb=gb,
                     biased=biased, loss=loss,
                     reg_u=REG_U * (inv_u[u] if freq else 1.0),
                     reg_i=REG_I * (inv_i[i] if freq else 1.0))
        np.testing.assert_allclose(out["user_factors"], W, atol=2e-5)
        np.testing.assert_allclose(out["item_factors"], H, atol=2e-5)
        if biased:
            np.testing.assert_allclose(out["user_bias"], bu, atol=2e-5)
            np.testing.assert_allclose(out["item_bias"], bi, atol=2e-5)


def _feedback():
    rng = np.random.default_rng(11)
    users, items = [], []
    for u, size in enumerate([2, 3, 5, 4, 6, 3, 7, 2]):
        for i in rng.choice(15, size=size, replace=False):
            users.append(u)
            items.append(int(i))
    return PosOnlyData(users, items, num_users=8, num_items=15)


class TestBPREpoch:
    """ops/bpr.py bpr_epoch at batch size 1: each batch's sampled triple
    (u, i, j) gets the reference's pairwise update."""

    @pytest.mark.parametrize("regime,soft_margin,update_j", [
        (bpr_ops.UNIFORM_USER, False, True),
        (bpr_ops.UNIFORM_USER, False, False),
        (bpr_ops.WBPR, False, True),
        (bpr_ops.WBPR, False, False),
        (bpr_ops.UNIFORM_USER, True, True),
        (bpr_ops.UNIFORM_USER, True, False),
        (bpr_ops.UNIFORM_PAIR, False, True),
        (bpr_ops.UNIFORM_PAIR_WOR, False, True),
    ])
    def test_batch_one_equals_sequential_rule(self, regime, soft_margin,
                                              update_j):
        fb = _feedback()
        sampler, meta = bpr_ops.make_sampler_data(fb)
        pop_cdf = bpr_ops.popularity_cdf(fb) if regime == bpr_ops.WBPR \
            else None
        f, nb = 4, 40
        rng = np.random.default_rng(3)
        W0 = rng.normal(0, 0.1, (8, f))
        H0 = rng.normal(0, 0.1, (15, f))
        b0 = rng.normal(0, 0.1, 15)
        lr, reg_u, reg_i, reg_j, breg = 0.1, 0.01, 0.02, 0.005, 0.05
        hp = {k: jnp.float32(v) for k, v in dict(
            learn_rate=lr, reg_u=reg_u, reg_i=reg_i, reg_j=reg_j,
            bias_reg=breg).items()}
        key = jax.random.PRNGKey(4)
        params = dict(user_factors=jnp.asarray(W0, jnp.float32),
                      item_factors=jnp.asarray(H0, jnp.float32),
                      item_bias=jnp.asarray(b0, jnp.float32))
        out = bpr_ops.bpr_epoch(
            params, sampler, key, hp, pop_cdf, batch_size=1,
            num_batches=nb, regime=regime,
            meta_static=tuple(sorted(meta.items())), update_j=update_j,
            soft_margin=soft_margin)

        perm = (jax.random.permutation(jax.random.fold_in(key, 0x5eed),
                                       jnp.arange(nb, dtype=jnp.int32))
                if regime == bpr_ops.UNIFORM_PAIR_WOR else None)
        W, H, bias = W0.copy(), H0.copy(), b0.copy()
        for b in range(nb):
            u, i, j, w = (np.asarray(a)[0] for a in bpr_ops._sample_triples(
                jax.random.fold_in(key, b), sampler, meta, 1, regime,
                perm=perm, batch_index=b, pop_cdf=pop_cdf))
            if w == 0:
                continue
            wu, hi, hj = W[u].copy(), H[i].copy(), H[j].copy()
            x = bias[i] - bias[j] + wu @ (hi - hj)
            g = float(x < 1.0) if soft_margin else _sigmoid(-x)
            W[u] += lr * (g * (hi - hj) - reg_u * wu)
            H[i] += lr * (g * wu - reg_i * hi)
            bias[i] += lr * (g - breg * bias[i])
            if update_j:
                H[j] += lr * (-g * wu - reg_j * hj)
                bias[j] += lr * (-g - breg * bias[j])
        np.testing.assert_allclose(out["user_factors"], W, atol=1e-5)
        np.testing.assert_allclose(out["item_factors"], H, atol=1e-5)
        np.testing.assert_allclose(out["item_bias"], bias, atol=1e-5)


class TestSvdppGroupedEpoch:
    """ops/svdpp.py svdpp_epoch through the model, one user per group:
    per user, s_u = p_u + |I_u|^-1/2 sum y_j is held fixed, the user's
    ratings update biases, p and q as one summed step from the same
    starting values, then y moves once through the user's history."""

    @pytest.mark.parametrize("name,loss,freq", [
        ("SVDPlusPlus", "RMSE", False),
        ("SVDPlusPlus", "RMSE", True),
        ("SigmoidSVDPlusPlus", "RMSE", False),
        ("SigmoidSVDPlusPlus", "MAE", False),
        ("SigmoidSVDPlusPlus", "LogisticLoss", False),
        ("SigmoidItemAsymmetricFactorModel", "RMSE", False),
    ])
    def test_one_user_groups_match_rule(self, name, loss, freq):
        from mymedialite_tpu.models.mf import OptimizationTarget
        from mymedialite_tpu.models.registry import create_rating_predictor
        users, items, values = _ratings(seed=8, U=7, I=10, n=35)
        data = RatingData(users, items, values, num_users=7, num_items=10)
        m = create_rating_predictor(name)
        m.SHARDABLE = False          # the single-device epoch
        m.num_factors = 3
        m.group_users = 1
        m.learn_rate = 0.05
        m.frequency_regularization = freq
        m.loss = OptimizationTarget(loss)
        m.ratings = data
        m.init_model()
        p0 = {k: np.asarray(v, np.float64) for k, v in m.params.items()}
        hp = {k: np.asarray(v, np.float64) for k, v in m._hp().items()}
        m.iterate()
        got = {k: np.asarray(v) for k, v in m.params.items()}

        loss_id = {"RMSE": sgd.LOSS_RMSE, "MAE": sgd.LOSS_MAE,
                   "LogisticLoss": sgd.LOSS_LOGISTIC}[loss]
        lr, blr, breg = hp["learn_rate"], hp["bias_learn_rate"], \
            hp["bias_reg"]
        lo, rng_ = hp["min_rating"], hp["rating_range"]
        gb = p0["global_bias"]
        bu, bi = p0["user_bias"].copy(), p0["item_bias"].copy()
        q, y = p0["item_factors"].copy(), p0["y"].copy()
        p = p0["p"].copy() if m.USE_P else None
        for u in range(7):
            rows = np.nonzero(users == u)[0]
            if rows.size == 0:
                continue
            hist = np.unique(items[rows])
            inv = 1.0 / np.sqrt(hist.size)
            s = inv * y[hist].sum(0) + (p[u] if m.USE_P else 0.0)
            d_bu, d_p, c = 0.0, np.zeros(3), np.zeros(3)
            d_bi, d_q = {}, {}
            for r in rows:
                i, v = int(items[r]), float(values[r])
                score = gb + bu[u] + bi[i] + s @ q[i]
                if m.SIGMOID:
                    sig = _sigmoid(score)
                    err = v - (lo + sig * rng_)
                    g = _grad(loss_id, err, sig, rng_)
                else:
                    g = v - score
                d_bu += blr * lr * (g - breg * hp["user_reg"][u] * bu[u])
                d_bi[i] = blr * lr * (g - breg * hp["item_reg"][i] * bi[i])
                if m.USE_P:
                    d_p += g * q[i] - hp["user_reg"][u] * p[u]
                d_q[i] = g * s - hp["item_reg"][i] * q[i]
                c += g * inv * q[i]
            bu[u] += d_bu
            if m.USE_P:
                p[u] += lr * d_p
            for i in d_bi:
                bi[i] += d_bi[i]
                q[i] += lr * d_q[i]
            y[hist] += lr * (c[None, :]
                             - rows.size * hp["y_reg"][hist][:, None]
                             * y[hist])
        want = dict(user_bias=bu, item_bias=bi, item_factors=q, y=y)
        if m.USE_P:
            want["p"] = p
        for k, v in want.items():
            np.testing.assert_allclose(got[k][:v.shape[0]], v, atol=2e-5,
                                       err_msg=k)
