"""SocialMF — matrix factorization with social (trust) regularization.

JAX counterpart of reference ``RatingPrediction/SocialMF.cs``
(Jamali & Ester, RecSys 2010): BiasedMF prediction with an extra
regularizer pulling each user's factors toward the mean factors of
their trusted users; trained by full-batch gradient descent
(reference IterateBatch :77-191).

On device the whole batch step is dense algebra: the rating-error gradient
is one segment scatter-add, and both social terms are matmuls with the
row-normalized trust matrix T:
    grad_social(P) = social_reg * [ D (P - T P) - T^T D (P - T P) ]
where D masks users that have at least one outgoing connection
(reference's ``num_connections != 0`` guard).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mymedialite_tpu.models.mf import BiasedMatrixFactorization
from mymedialite_tpu.ops import sgd


class SocialMF(BiasedMatrixFactorization):
    REQUIRED_SIDE_INFO = ("user_relation",)
    HYPERPARAMS = dict(BiasedMatrixFactorization.HYPERPARAMS,
                       social_regularization=float)

    def __init__(self):
        super().__init__()
        self.social_regularization = 1.0
        self.user_relation = None  # InteractionData: user -> trusted user
        self._T = None

    def _trust_matrix(self, num_users):
        T = np.zeros((num_users, num_users), dtype=np.float32)
        if self.user_relation is not None:
            u = np.asarray(self.user_relation.users)
            v = np.asarray(self.user_relation.items)
            keep = (u < num_users) & (v < num_users)
            u, v = u[keep], v[keep]
            T[u, v] = 1.0
            counts = T.sum(axis=1, keepdims=True)
            T = np.divide(T, counts, out=T, where=counts > 0)
        return T

    def init_model(self):
        # grow the user space to cover relation-only users
        # (reference SocialMF.InitModel :57-66)
        if self.user_relation is not None and len(self.user_relation):
            n = max(self.user_relation.num_users, self.user_relation.num_items)
            if n > self.ratings.num_users:
                self.ratings = self.ratings.select(
                    np.arange(len(self.ratings)), num_users=n)
                self.num_users_trained = n
        super().init_model()
        U = self.num_users_trained
        T = self._trust_matrix(U)
        self._T = jnp.asarray(T)
        self._has_conn = jnp.asarray((T.sum(axis=1) > 0)
                                     .astype(np.float32))
        self._flat_data()  # rating arrays for the batch gradient

    def _ensure_epoch_ready(self):
        """Also rebuild the trust matrix and the flat rating arrays after
        load_model (reference Train/Iterate split)."""
        super()._ensure_epoch_ready()
        if self._T is None:
            U = self.num_users_trained
            T = self._trust_matrix(U)
            self._T = jnp.asarray(T)
            self._has_conn = jnp.asarray((T.sum(axis=1) > 0)
                                         .astype(np.float32))
        self._flat_data()

    def iterate(self, update_user: bool = True, update_item: bool = True):
        self._ensure_epoch_ready()
        data = self._flat_cache
        U = self.num_users_trained
        f = self.num_factors
        self.W_ext, self.H_ext = _social_mf_step(
            self.W_ext, self.H_ext, data, self._T, self._has_conn,
            dict(global_bias=jnp.float32(self.global_bias),
                 min_rating=jnp.float32(self.min_rating),
                 rating_range=jnp.float32(
                     max(self.max_rating - self.min_rating, 1e-9)),
                 learn_rate=jnp.float32(self.current_learnrate),
                 bias_learn_rate=jnp.float32(self.bias_learn_rate),
                 reg_u=jnp.float32(self.reg_u),
                 reg_i=jnp.float32(self.reg_i),
                 bias_reg=jnp.float32(self.bias_reg),
                 social_reg=jnp.float32(self.social_regularization)),
            num_users=U, num_factors=f, loss=self.loss_id,
            update_user=update_user, update_item=update_item)
        self.update_learn_rate()


@functools.partial(
    jax.jit,
    static_argnames=("num_users", "num_factors", "loss", "update_user",
                     "update_item"),
    donate_argnames=("W_ext", "H_ext"))
def _social_mf_step(W_ext, H_ext, data, T, has_conn, hp, *, num_users: int,
                    num_factors: int, loss: int, update_user: bool,
                    update_item: bool):
    f = num_factors
    U = num_users
    u, i, v, w = data["users"], data["items"], data["values"], data["weights"]

    wu = W_ext[u]
    hi = H_ext[i]
    score = hp["global_bias"] + jnp.sum(wu * hi, axis=-1)
    sig = jax.nn.sigmoid(score)
    pred = hp["min_rating"] + sig * hp["rating_range"]
    err = pred - v  # reference SocialMF uses prediction - rating
    g = sgd._gradient_common(loss, err, sig, hp["rating_range"]) * w

    # rating-error gradients via scatter-add
    grad_W = jnp.zeros_like(W_ext).at[u].add(g[:, None] * hi)
    grad_H = jnp.zeros_like(H_ext).at[i].add(g[:, None] * wu)

    # L2 (reference I.2): factors with reg, bias column with reg*bias_reg,
    # constant column frozen below via the column rate vectors
    fe = W_ext.shape[1]
    w_l2 = jnp.array([hp["reg_u"]] * f + [hp["reg_u"] * hp["bias_reg"], 0.0])
    h_l2 = jnp.array([hp["reg_i"]] * f + [0.0, hp["reg_i"] * hp["bias_reg"]])
    grad_W = grad_W + W_ext * w_l2[None, :]
    grad_H = grad_H + H_ext * h_l2[None, :]

    # social regularization (reference I.3; factors + bias column together,
    # constant column masked). Only the first U rows participate.
    P = W_ext[:U, :f + 1]  # factors and the user-bias column
    # HIGHEST: gradient math, a TF32 product would round the factors
    hi = jax.lax.Precision.HIGHEST
    TP = jnp.dot(T, P, precision=hi, preferred_element_type=jnp.float32)
    M1 = has_conn[:, None] * (P - TP)
    social = hp["social_reg"] * (M1 - jnp.dot(
        T.T, M1, precision=hi, preferred_element_type=jnp.float32))
    grad_W = grad_W.at[:U, :f + 1].add(social)

    w_lr = jnp.array([hp["learn_rate"]] * f +
                     [hp["learn_rate"] * hp["bias_learn_rate"], 0.0])
    h_lr = jnp.array([hp["learn_rate"]] * f +
                     [0.0, hp["learn_rate"] * hp["bias_learn_rate"]])
    if update_user:
        W_ext = W_ext - grad_W * w_lr[None, :]
    if update_item:
        H_ext = H_ext - grad_H * h_lr[None, :]
    return W_ext, H_ext
