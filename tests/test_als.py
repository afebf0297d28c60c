"""Unit tests for the WRMF ALS substrate (ops/als.py).

The batched normal-equation solves replace the reference's per-row
MathNet ``DenseMatrix.Inverse()`` (``WRMF.cs:110-156``); the batched
Cholesky solve is checked directly against a float64 oracle,
independent of the model-level quality tests.
"""

import numpy as np

import jax.numpy as jnp

from mymedialite_tpu.ops.als import (
    _batched_spd_solve,
    wrmf_optimize,
    wrmf_solve_row,
)


class TestBatchedSpdSolve:
    def test_matches_numpy_solve(self):
        rng = np.random.default_rng(0)
        C, f = 64, 40
        A = rng.standard_normal((C, f, 12)).astype(np.float32)
        M = np.einsum("cfk,cgk->cfg", A, A) \
            + 0.015 * np.eye(f, dtype=np.float32)
        b = rng.standard_normal((C, f)).astype(np.float32)
        x = np.asarray(_batched_spd_solve(jnp.asarray(M), jnp.asarray(b)))
        xr = np.linalg.solve(M.astype(np.float64),
                             b.astype(np.float64)[..., None])[..., 0]
        resid = np.abs(x - xr).max() / np.abs(xr).max()
        assert resid < 5e-4

    def test_well_conditioned_high_accuracy(self):
        rng = np.random.default_rng(1)
        C, f = 16, 8
        A = rng.standard_normal((C, f, f)).astype(np.float32)
        M = np.einsum("cfk,cgk->cfg", A, A) + np.eye(f, dtype=np.float32)
        b = rng.standard_normal((C, f)).astype(np.float32)
        x = np.asarray(_batched_spd_solve(jnp.asarray(M), jnp.asarray(b)))
        xr = np.linalg.solve(M.astype(np.float64),
                             b.astype(np.float64)[..., None])[..., 0]
        assert np.abs(x - xr).max() < 1e-4

    def test_identity_regularized_empty_history(self):
        # M = reg*I (a padded empty-history row): x = b * (1+alpha)/reg
        f = 6
        M = 0.5 * np.eye(f, dtype=np.float32)[None]
        b = np.arange(f, dtype=np.float32)[None]
        x = np.asarray(_batched_spd_solve(jnp.asarray(M), jnp.asarray(b)))
        np.testing.assert_allclose(x, b / 0.5, rtol=1e-6)


class TestWrmfOptimize:
    def test_matches_dense_oracle(self):
        """Per-row closed form (reference WRMF.cs:110-156):
        W[u] = (HtH + alpha*H_S^T H_S + reg I)^-1 (1+alpha) sum H_i."""
        rng = np.random.default_rng(3)
        I, f, U, L = 30, 5, 8, 6
        H = rng.standard_normal((I, f)).astype(np.float32)
        hist = rng.integers(0, I, (U, L)).astype(np.int32)
        lens = rng.integers(0, L + 1, U).astype(np.int32)
        alpha, reg = 0.7, 0.03
        W = np.asarray(wrmf_optimize(jnp.asarray(H), jnp.asarray(hist),
                                     jnp.asarray(lens),
                                     jnp.float32(alpha), jnp.float32(reg),
                                     chunk=4))
        HH = H.T @ H
        for u in range(U):
            S = hist[u, :lens[u]]
            M = HH + alpha * H[S].T @ H[S] + reg * np.eye(f)
            rhs = (1 + alpha) * H[S].sum(axis=0) if lens[u] else \
                np.zeros(f, np.float32)
            np.testing.assert_allclose(W[u], np.linalg.solve(M, rhs),
                                       atol=2e-4)

    def test_solve_row_matches_batch(self):
        rng = np.random.default_rng(4)
        I, f = 25, 5
        H = jnp.asarray(rng.standard_normal((I, f)).astype(np.float32))
        ids = np.array([3, 7, 11, 19], np.int32)
        row = np.asarray(wrmf_solve_row(H, ids, jnp.float32(1.0),
                                        jnp.float32(0.015)))
        hist = np.zeros((1, 4), np.int32)
        hist[0] = ids
        full = np.asarray(wrmf_optimize(H, jnp.asarray(hist),
                                        jnp.asarray([4], np.int32),
                                        jnp.float32(1.0),
                                        jnp.float32(0.015), chunk=1))
        np.testing.assert_allclose(row, full[0], atol=1e-5)
