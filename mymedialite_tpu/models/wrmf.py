"""WRMF — weighted regularized matrix factorization (implicit ALS).

JAX counterpart of reference ``ItemRecommendation/WRMF.cs:53-180``
(Hu/Koren/Volinsky 2008). Alternation solves every user row then every
item row in closed form; here each side is one batched-solve call
(ops/als.py) instead of a Parallel.For + per-row matrix inverse.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mymedialite_tpu.models.bpr import ItemMF
from mymedialite_tpu.ops.als import wrmf_optimize, wrmf_solve_row


class WRMF(ItemMF):
    HYPERPARAMS = {
        "num_factors": int,
        "regularization": float,
        "alpha": float,
        "num_iter": int,
    }
    EXTRA_PARAMS = dict(ItemMF.EXTRA_PARAMS, solve_chunk=int)

    def __init__(self):
        super().__init__()
        # defaults per reference WRMF.cs:56-65
        self.alpha = 1.0
        self.regularization = 0.015
        self.num_iter = 15
        self.solve_chunk = 256
        self._user_hist = None
        self._item_hist = None
        self._mesh = None

    def init_model(self):
        super().init_model()
        self._mesh = self._make_mesh()
        self._build_histories()

    def _make_mesh(self):
        """Row solves are embarrassingly parallel (reference Parallel.For,
        WRMF.cs:87-91): shard them over the mesh when devices > 1."""
        import jax
        if len(jax.devices()) <= 1:
            return None
        from mymedialite_tpu.parallel.mesh import make_mesh
        return make_mesh()

    def _build_histories(self):
        f = self.feedback
        self._user_hist = self._bucketize(f.by_user, f.num_users)
        self._item_hist = self._bucketize(f.by_item, f.num_items)

    # gathered-history memory budget per solve step: chunk * L * f floats
    _GATHER_BUDGET = 2_097_152  # chunk * L <= 2M (f=40 -> ~320 MB)

    def _bucketize(self, csr, num_rows: int):
        """Length-bucketed padded histories: rows grouped by history length
        into power-of-two buckets, bounding memory at O(2*nnz) instead of
        the rectangular O(rows * Lmax) (power-law data: one 17k-item user
        would force a 480k x 17k dense history). Returns a list of
        (row_ids, hist_dev [nb_pad, L], lens_dev [nb_pad], chunk)."""
        counts = csr.counts()[:num_rows]
        ndev = self._mesh.devices.size if self._mesh is not None else 1
        bounds = [16]
        while bounds[-1] < max(int(counts.max()) if counts.size else 1, 1):
            bounds.append(bounds[-1] * 2)
        bidx = np.searchsorted(bounds, counts)
        buckets = []
        for b_i, L in enumerate(bounds):
            rows = np.nonzero(bidx == b_i)[0]
            if rows.size == 0:
                continue
            cap = max(self._GATHER_BUDGET // L, 8)
            chunk = min(self.solve_chunk, 1 << (cap.bit_length() - 1))
            mult = chunk * ndev
            nb_pad = ((rows.size + mult - 1) // mult) * mult
            hist = np.zeros((nb_pad, L), np.int32)
            lens = np.zeros(nb_pad, np.int32)
            cnt_r = counts[rows].astype(np.int64)
            lens[:rows.size] = cnt_r
            # vectorized ragged fill (a per-row python loop is minutes at
            # 480k rows): flat positions within each row's segment
            total = int(cnt_r.sum())
            row_rep = np.repeat(np.arange(rows.size, dtype=np.int64), cnt_r)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(cnt_r) - cnt_r, cnt_r)
            starts = np.repeat(csr.indptr[rows].astype(np.int64), cnt_r)
            hist[row_rep, within] = csr.keys[starts + within]
            buckets.append((rows, self._put(hist, lens), chunk))
        return buckets

    def _put(self, hist, lens):
        if self._mesh is None:
            return jnp.asarray(hist), jnp.asarray(lens)
        import jax
        from mymedialite_tpu.parallel.mesh import row_sharded, row_sharded_2d
        return (jax.device_put(hist, row_sharded_2d(self._mesh)),
                jax.device_put(lens, row_sharded(self._mesh)))

    def _optimize(self, H, buckets, alpha, reg, num_rows: int):
        """Solve all rows bucket by bucket (each bucket an independent
        batched solve; per-row results identical to the rectangular
        layout since every row's system only involves its own history)."""
        f = H.shape[1]
        W = jnp.zeros((num_rows, f), H.dtype)
        for rows, (hist, lens), chunk in buckets:
            if self._mesh is None:
                Wb = wrmf_optimize(H, hist, lens, alpha, reg, chunk=chunk)
            else:
                import jax
                from mymedialite_tpu.ops.als import wrmf_optimize_sharded
                from mymedialite_tpu.parallel.mesh import replicated
                H_rep = jax.device_put(np.asarray(H),
                                       replicated(self._mesh))
                Wb = jnp.asarray(np.asarray(wrmf_optimize_sharded(
                    self._mesh, H_rep, hist, lens, alpha, reg,
                    chunk=chunk)))
            W = W.at[jnp.asarray(rows)].set(Wb[:rows.size])
        return W

    def _ensure_epoch_ready(self):
        """Lazily rebuild mesh + histories when missing — e.g. after
        ``load_model`` — so ``iterate()`` keeps training (reference
        Model.Load + --find-iter contract, IO/Model.cs:67-83)."""
        if self._user_hist is not None:
            return
        if self.feedback is None:
            raise RuntimeError(
                "WRMF: no feedback set; assign .feedback before "
                "iterating a loaded model")
        self._grow_tables()
        self._mesh = self._make_mesh()

    def iterate(self):
        """One alternation (reference WRMF.Iterate :68-73)."""
        self._ensure_epoch_ready()
        if getattr(self, "_hist_dirty", False) or self._user_hist is None:
            self._build_histories()
            self._hist_dirty = False
        p = self.params
        alpha = jnp.float32(self.alpha)
        reg = jnp.float32(self.regularization)
        p["user_factors"] = self._optimize(
            p["item_factors"], self._user_hist, alpha, reg,
            p["user_factors"].shape[0])
        p["item_factors"] = self._optimize(
            p["user_factors"], self._item_hist, alpha, reg,
            p["item_factors"].shape[0])

    def retrain_user(self, user_id: int):
        """Re-solve ONLY this user's row against the current item factors
        (reference WRMF.RetrainUser, WRMF.cs:158-163); every other row is
        bit-unchanged."""
        p = self.params
        idx = self.feedback.by_user.segment(user_id)
        row = wrmf_solve_row(p["item_factors"], self.feedback.items[idx],
                             jnp.float32(self.alpha),
                             jnp.float32(self.regularization))
        p["user_factors"] = p["user_factors"].at[user_id].set(row)

    def retrain_item(self, item_id: int):
        """Reference WRMF.RetrainItem, WRMF.cs:165-172."""
        p = self.params
        idx = self.feedback.by_item.segment(item_id)
        row = wrmf_solve_row(p["user_factors"], self.feedback.users[idx],
                             jnp.float32(self.alpha),
                             jnp.float32(self.regularization))
        p["item_factors"] = p["item_factors"].at[item_id].set(row)

    def _retrain(self, users, items):
        """Re-solve only the touched rows (reference RetrainUser /
        RetrainItem, WRMF.cs:158-172); the full padded histories used by
        iterate() are rebuilt lazily if training resumes."""
        if self.params is None:
            return
        self._grow_tables()
        self._hist_dirty = True
        if self.update_users:
            for u in np.unique(np.asarray(users, dtype=np.int64)):
                self.retrain_user(int(u))
        if self.update_items:
            for i in np.unique(np.asarray(items, dtype=np.int64)):
                self.retrain_item(int(i))

    def _grow_tables(self):
        f = self.feedback
        p = self.params
        for side, n in (("user_factors", f.num_users),
                        ("item_factors", f.num_items)):
            grow = n - p[side].shape[0]
            if grow > 0:
                p[side] = jnp.concatenate(
                    [p[side], jnp.zeros((grow, self.num_factors))])
        self.num_users_trained = max(self.num_users_trained, f.num_users)
        self.num_items_trained = max(self.num_items_trained, f.num_items)
