"""The kept array-level workarounds against the plain ops they replace:
the banked (windowed) gather vs ``W[ids]`` and the per-batch dedup
scatter vs ``.at[ids].add``; and the WRMF batched Cholesky solve vs
``np.linalg.solve`` across factor widths. Each must give the plain
op's result."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mymedialite_tpu.ops import gather as bg
from mymedialite_tpu.ops import sgd
from mymedialite_tpu.ops.als import _batched_spd_solve


class TestBankedGather:
    @pytest.mark.parametrize("rows,n,cols", [
        (bg.WINDOW, 10, 4),          # one window, one short segment
        (70_000, 1_000, 4),          # ids across two windows
        (200_000, 150_000, 3),       # several full segments and windows
    ])
    def test_equals_plain_gather(self, rows, n, cols):
        rng = np.random.default_rng(rows)
        table = rng.standard_normal((rows, cols)).astype(np.float32)
        ids = np.sort(rng.integers(0, rows, n)).astype(np.int32)
        seg_ids, bases, fills = bg.banked_plan(ids)
        assert seg_ids.shape[1] == bg.SEG_C and int(fills.sum()) == n
        assert (seg_ids.max(axis=1) - bases < bg.WINDOW).all()
        got = np.asarray(jax.jit(bg.banked_take)(
            jnp.asarray(table), jnp.asarray(seg_ids), jnp.asarray(bases)))
        real = np.concatenate([np.arange(f) + s * bg.SEG_C
                               for s, f in enumerate(fills)])
        np.testing.assert_array_equal(got[real], table[ids])


class TestBatchedSpdSolveAcrossWidths:
    @pytest.mark.parametrize("f", [1, 2, 3, 8, 16, 40])
    def test_matches_numpy_solve(self, f):
        rng = np.random.default_rng(f)
        C = 32
        A = rng.standard_normal((C, f, f + 4)).astype(np.float32)
        M = np.einsum("cfk,cgk->cfg", A, A) + 0.5 * np.eye(f,
                                                          dtype=np.float32)
        b = rng.standard_normal((C, f)).astype(np.float32)
        x = np.asarray(jax.jit(_batched_spd_solve)(jnp.asarray(M),
                                                    jnp.asarray(b)))
        ref = np.linalg.solve(M.astype(np.float64),
                              b.astype(np.float64)[..., None])[..., 0]
        assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-4


class TestDedupScatter:
    @pytest.mark.parametrize("n,rows,batch", [
        (64, 5, 16),        # heavy duplication
        (100, 1000, 32),    # mostly unique, padded last batch
        (96, 1, 8),         # one row
    ])
    def test_equals_duplicate_scatter_add(self, n, rows, batch):
        rng = np.random.default_rng(n + rows)
        ids = rng.integers(0, rows, n).astype(np.int32)
        n_pad = sgd.pad_to_batches(n, batch)
        ids = np.concatenate([ids, np.zeros(n_pad - n, np.int32)])
        delta = rng.standard_normal((n_pad, 3)).astype(np.float32)
        delta[n:] = 0.0
        slots, uniq = sgd._dedup_per_batch(ids, batch, rows)
        table = jnp.asarray(rng.standard_normal((rows, 3)), jnp.float32)
        got, want = table, table
        for b in range(n_pad // batch):
            s = slice(b * batch, (b + 1) * batch)
            got = sgd._dedup_scatter_add(got, jnp.asarray(slots[s]),
                                         jnp.asarray(uniq[s]),
                                         jnp.asarray(delta[s]), batch)
            want = want.at[jnp.asarray(ids[s])].add(jnp.asarray(delta[s]))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    def test_slot_structure(self):
        ids = np.array([3, 1, 3, 0, 2, 2, 2, 2], np.int32)
        slots, uniq = sgd._dedup_per_batch(ids, 4, 4)
        # per batch: unique sorted ids, then out-of-range sentinels
        np.testing.assert_array_equal(uniq[:4], [0, 1, 3, 4])
        np.testing.assert_array_equal(uniq[4:], [2, 4, 5, 6])
        np.testing.assert_array_equal(uniq[slots[:4]], ids[:4])
        np.testing.assert_array_equal(uniq[4:][slots[4:]], ids[4:])
