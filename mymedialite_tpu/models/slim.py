"""SLIM — sparse linear item-item models.

JAX counterparts of reference ``ItemRecommendation/SLIM.cs:45``
(abstract W-matrix base; Predict = sum_{j in I_u} W[i,j]),
``LeastSquareSLIM.cs:55`` (elastic-net coordinate descent, optional
item-kNN feature selection) and ``BPRSLIM.cs:56`` (BPR-sampled SGD on W).

Design notes:
- W is dense [I, I] on device (the reference also allocates a dense
  Matrix<float>; SLIM targets modest catalogs).
- LeastSquareSLIM: the reference's per-coordinate update
  (LeastSquareSLIM.cs:140-176) is rewritten as full Jacobi-style sweeps:
  the gradient for every (i,j) at once is two matmuls
  (S = M W^T, A = S^T M) plus the precomputed co-occurrence matrix, then
  the same soft-threshold. Each sweep touches every coordinate with
  start-of-sweep predictions instead of cycling; validated by ranking
  quality, not per-coordinate trajectories.
- BPRSLIM: sampled (u, i+, j-) triples; the per-triple update touches
  W[i, k] / W[j, k] for all k in I_u — done with padded histories and
  flat scatter-adds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mymedialite_tpu.data.arrays import padded_history
from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu.models.base import (
    IncrementalItemRecommender, IterativeModel,
)
from mymedialite_tpu.ops import bpr as bpr_ops
from mymedialite_tpu.ops import correlation as corr_ops


def _slim_catalog(params, users):
    """Pure catalog scorer (module-level: stable jit identity; see
    Recommender.catalog_scorer): per user, build the 0/1 history
    incidence row ON DEVICE from the padded histories and take one
    matmul against W.T (default precision, like every catalog scorer)."""
    hist, lens, W = params["hist"], params["lens"], params["W"]
    import jax.numpy as jnp
    u = jnp.clip(users, 0, hist.shape[0] - 1)
    h = hist[u]                                        # [B, L]
    L = hist.shape[1]
    I = W.shape[0]
    m = (jnp.arange(L)[None, :] < lens[u][:, None]).astype(jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(u.shape[0])[:, None], h.shape)
    A = jnp.zeros((u.shape[0], I), jnp.float32)
    A = A.at[rows.reshape(-1),
             jnp.clip(h, 0, I - 1).reshape(-1)].max(m.reshape(-1))
    return A @ W.T


class _SLIM(IncrementalItemRecommender, IterativeModel):
    EXTRA_PARAMS = {"init_mean": float, "init_stdev": float}

    def __init__(self):
        super().__init__()
        # defaults per reference SLIM.cs:63-68
        self.num_iter = 15
        self.init_mean = 0.0
        self.init_stdev = 0.1
        self.random_seed = 42
        self.W = None  # [I, I] item weights, zero diagonal

    def init_model(self):
        I = self.feedback.num_items
        key = jax.random.PRNGKey(self.random_seed)
        W = self.init_mean + self.init_stdev * jax.random.normal(
            key, (I, I), dtype=jnp.float32)
        self.W = W * (1.0 - jnp.eye(I, dtype=jnp.float32))
        self._score_hist = None      # feedback-derived; rebuilt lazily

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def predict_batch(self, users, items):
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        out = np.full(users.shape, -np.float32(3.4e38), dtype=np.float32)
        ok = (users >= 0) & (users < self.feedback.num_users) & \
             (items >= 0) & (items < self.W.shape[0])
        if ok.any():
            uniq = np.unique(users[ok])
            scores = self.score_catalog(uniq)
            row_of = {int(u): r for r, u in enumerate(uniq)}
            rows = np.array([row_of[int(u)] for u in users[ok]])
            out[ok] = scores[rows, items[ok]]
        return out

    def score_catalog(self, users):
        return np.asarray(self.score_catalog_device(users))

    def catalog_scorer(self):
        if self.W is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        hl = getattr(self, "_score_hist", None)
        if hl is None:
            hist, lens = padded_history(self.feedback.by_user)
            hl = (jnp.asarray(hist), jnp.asarray(lens))
            self._score_hist = hl
        return _slim_catalog, dict(hist=hl[0], lens=hl[1], W=self.W)

    def _retrain(self, users, items):
        if self.W is not None:
            self.train()

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "3.05") as w:
            w.matrix(np.asarray(self.W))

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.W = jnp.asarray(r.matrix())
        self.num_items_trained = self.W.shape[0]


class LeastSquareSLIM(_SLIM):
    """Reference LeastSquareSLIM.cs:55 — elastic-net coordinate descent
    with optional kNN feature selection (K=50 cosine neighbors)."""

    HYPERPARAMS = {
        "reg_l1": float,
        "reg_l2": float,
        "k": int,
        "num_iter": int,
    }

    def __init__(self):
        super().__init__()
        self.reg_l1 = 0.01
        self.reg_l2 = 0.001
        self.k = 50
        # Jacobi damping: the reference's per-coordinate cyclic descent
        # (Gauss-Seidel) converges, but the all-coordinates-at-once
        # Jacobi sweep OSCILLATES undamped (measured period-2 AUC
        # 0.81/0.23 at an ML-small shape); 0.5 averaging restores stable
        # convergence while keeping the sweep a single matmul
        self.damping = 0.5

    def init_model(self):
        # W starts at ZERO like the reference (SLIM.cs InitModel
        # allocates a zero Matrix<float>): the first sweep then yields
        # the soft-thresholded co-occurrence weights — a strong,
        # deterministic warm start; random init leaves Jacobi noise
        I = self.feedback.num_items
        self.W = jnp.zeros((I, I), dtype=jnp.float32)
        self._score_hist = None      # feedback-derived; rebuilt lazily
        self._build_epoch_state()

    def _ensure_epoch_ready(self):
        """Lazily rebuild feedback-derived sweep state after load_model
        (reference Model.Load + --find-iter contract, IO/Model.cs:67-83)."""
        if getattr(self, "_C", None) is None:
            if self.feedback is None:
                raise RuntimeError("LeastSquareSLIM: no feedback set")
            self._build_epoch_state()

    def _build_epoch_state(self):
        f = self.feedback
        I = f.num_items
        # co-occurrence C = M^T M and column counts WITHOUT the dense
        # [U, I] f32 incidence (34 GB at Netflix user counts): slab
        # Gram over the int8 incidence, counts from host unique pairs.
        # The sweep itself only needs C — S^T M = W M^T M = W C.
        chunk = 4096
        n_pad = ((f.num_users + chunk - 1) // chunk) * chunk
        # scatter-free int8 incidence from the bit-packed device build
        # (ops/correlation.py _incidence_int8); width is I rounded up to
        # 8 with zero pad columns, cut back after the Gram
        A8, pairs = corr_ops._incidence_int8(
            np.asarray(f.users, np.int32), np.asarray(f.items, np.int32),
            n_pad=n_pad, m=I)
        mb = A8.shape[1]
        C = jnp.zeros((mb, mb), jnp.float32)
        for r0 in range(0, n_pad, 16_384):
            rows = min(16_384, n_pad - r0)
            C = _gram_slab(C, A8, jnp.int32(r0), rows=rows)
        self._C = C[:I, :I] if mb != I else C
        del A8, C
        uf = pairs % mb
        self._cj = jnp.asarray(np.bincount(uf, minlength=I)[:I]
                               .astype(np.float32))
        self._num_users = f.num_users
        if self.k > 0:
            # feature selection: only the k most cosine-similar items
            # may get nonzero weight (reference InitModel +
            # GetMostSimilarItems) — streaming top-k over the item-major
            # view (the dense [I, U] f32 incidence is equally infeasible)
            view = type("V", (), dict(users=f.items, items=f.users))
            nn, _vals = corr_ops.binary_correlation_topk(
                view, I, f.num_users, k=self.k, kind="cosine")
            mask = np.zeros((I, I), dtype=np.float32)
            rows = np.repeat(np.arange(I), nn.shape[1])
            mask[rows, nn.reshape(-1)] = 1.0
            np.fill_diagonal(mask, 0.0)
            self._mask = jnp.asarray(mask)
        else:
            self._mask = 1.0 - jnp.eye(I, dtype=jnp.float32)

    def iterate(self):
        self._ensure_epoch_ready()
        new_w = _ls_slim_sweep(self.W, self._C, self._cj, self._mask,
                               jnp.float32(self._num_users),
                               jnp.float32(self.reg_l1),
                               jnp.float32(self.reg_l2))
        d = jnp.float32(self.damping)
        self.W = (1.0 - d) * self.W + d * new_w


import functools as _functools  # noqa: E402


@_functools.partial(jax.jit, static_argnames=("rows",),
                    donate_argnames=("C",))
def _gram_slab(C, A8, row0, *, rows: int):
    """C += slab^T slab over one int8 incidence row-slab (0/1 exact in
    bf16; counts < 2^24 exact in the f32 accumulator, so the default
    precision is exact on every backend)."""
    S = jax.lax.dynamic_slice(
        A8, (row0, 0), (rows, A8.shape[1])).astype(jnp.bfloat16)
    return C + jax.lax.dot_general(S, S, (((0,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)


@jax.jit
def _ls_slim_sweep(W, C, cj, mask, num_users, reg_l1, reg_l2):
    """One Jacobi sweep of the elastic-net coordinate update
    (reference UpdateParameters, LeastSquareSLIM.cs:140-176):
      grad[i,j] = (C[i,j] - (sum_{u in U_j} pred(u,i) - c_j W[i,j])) / U
      W[i,j] = soft_threshold(grad, l1) / (1 + l2), masked.
    The prediction sum collapses algebraically: S^T M = W M^T M = W C,
    so the sweep is ONE [I, I] x [I, I] matmul — no user-dimension
    tensor at all."""
    # HIGHEST: W is learned float32, a TF32 product would round it
    A = jnp.dot(W, C, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)           # [I, I]
    grad = (C - (A - cj[None, :] * W)) / num_users
    new_w = jnp.where(
        jnp.abs(grad) > reg_l1,
        (grad - jnp.sign(grad) * reg_l1) / (1.0 + reg_l2),
        0.0)
    return new_w * mask


class BPRSLIM(_SLIM):
    """Reference BPRSLIM.cs:56 — SLIM trained with BPR triple sampling."""

    HYPERPARAMS = {
        "reg_i": float,
        "reg_j": float,
        "num_iter": int,
        "learn_rate": float,
        "uniform_user_sampling": bool,
        "with_replacement": bool,
        "update_j": bool,
    }
    EXTRA_PARAMS = dict(_SLIM.EXTRA_PARAMS, batch_size=int,
                        num_neg_trials=int)

    def __init__(self):
        super().__init__()
        self.learn_rate = 0.05
        self.reg_i = 0.0025
        self.reg_j = 0.00025
        self.uniform_user_sampling = True
        self.with_replacement = False
        self.update_j = True
        self.batch_size = 1024
        self.num_neg_trials = 8

    def init_model(self):
        super().init_model()
        self._build_epoch_state()

    def _build_epoch_state(self):
        self._sampler, self._meta = bpr_ops.make_sampler_data(
            self.feedback, self.num_neg_trials)
        hist, lens = padded_history(self.feedback.by_user)
        self._hist = jnp.asarray(hist)
        self._lens = jnp.asarray(lens)

    def _ensure_epoch_ready(self):
        """Lazily rebuild sampler state after load_model (reference
        Model.Load + --find-iter contract, IO/Model.cs:67-83)."""
        if getattr(self, "_sampler", None) is None:
            if self.feedback is None:
                raise RuntimeError("BPRSLIM: no feedback set")
            self._build_epoch_state()

    def iterate(self):
        self._ensure_epoch_ready()
        meta = self._meta
        B = min(self.batch_size, max(meta["num_events"], 1))
        num_batches = max((meta["num_events"] + B - 1) // B, 1)
        key = jax.random.fold_in(jax.random.PRNGKey(self.random_seed),
                                 np.random.randint(0, 2**31 - 1))
        self.W = _bpr_slim_epoch(
            self.W, self._sampler, self._hist, self._lens, key,
            jnp.float32(self.learn_rate), jnp.float32(self.reg_i),
            jnp.float32(self.reg_j),
            batch_size=B, num_batches=num_batches,
            meta_static=tuple(sorted(meta.items())),
            regime=(bpr_ops.UNIFORM_USER if self.uniform_user_sampling
                    else bpr_ops.UNIFORM_PAIR),
            update_j=self.update_j)


import functools  # noqa: E402


@functools.partial(
    jax.jit,
    static_argnames=("batch_size", "num_batches", "meta_static", "regime",
                     "update_j"),
    donate_argnames=("W",))
def _bpr_slim_epoch(W, sampler, hist, lens, key, lr, reg_i, reg_j, *,
                    batch_size, num_batches, meta_static, regime, update_j):
    """Per batch, the per-triple updates over all k in I_u are expressed
    as dense [B, I] incidence rows + two ``one_hot.T @ delta``
    matmuls instead of flat scatter-adds of every (i, k) row entry
    (~28 GFLOP/batch at the ML-1M shape)."""
    meta = dict(meta_static)
    I = W.shape[0]
    L = hist.shape[1]

    def batch_step(W, b):
        bkey = jax.random.fold_in(key, b)
        u, i, j, w = bpr_ops._sample_triples(bkey, sampler, meta, batch_size,
                                             regime)
        B = u.shape[0]
        hu = hist[u]                                    # [B, L]
        hmask = (jnp.arange(L)[None, :] <
                 lens[u][:, None]).astype(jnp.float32)  # [B, L]
        hu_c = jnp.clip(hu, 0, I - 1)
        # dense incidence rows A[b, k] = 1 iff k in I_u(b)
        rows = jnp.broadcast_to(jnp.arange(B)[:, None], hu_c.shape)
        A = jnp.zeros((B, I), jnp.float32).at[
            rows.reshape(-1), hu_c.reshape(-1)].max(hmask.reshape(-1))
        iota = jnp.arange(I)[None, :]
        Pi = (iota == i[:, None]).astype(jnp.float32)   # [B, I] one-hot
        Pj = (iota == j[:, None]).astype(jnp.float32)
        # row gathers as one-hot matmuls too; HIGHEST keeps them exact
        # (a TF32 product would round the gathered rows)
        hi = jax.lax.Precision.HIGHEST
        wi = jnp.dot(Pi, W, precision=hi, preferred_element_type=jnp.float32)
        wj = jnp.dot(Pj, W, precision=hi, preferred_element_type=jnp.float32)
        # x_uij = sum_k (W[i,k] - W[j,k]) over k in I_u (diag is 0)
        x = jnp.sum((wi - wj) * A, axis=1)
        g = jax.nn.sigmoid(-x) * w                      # [B]
        # W[i, k] += lr (g - reg_i W[i,k]); k in I_u, k != i
        Xi = lr * (g[:, None] - reg_i * wi) * A * (iota != i[:, None])
        W = W + jax.lax.dot_general(
            Pi, Xi, (((0,), (0,)), ((), ())), precision=hi,
            preferred_element_type=jnp.float32)
        if update_j:
            Xj = lr * (-g[:, None] - reg_j * wj) * A * (iota != j[:, None])
            W = W + jax.lax.dot_general(
                Pj, Xj, (((0,), (0,)), ((), ())), precision=hi,
                preferred_element_type=jnp.float32)
        return W, None

    W, _ = jax.lax.scan(batch_step, W, jnp.arange(num_batches,
                                                  dtype=jnp.int32))
    return W
