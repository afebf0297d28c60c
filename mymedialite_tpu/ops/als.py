"""Batched ALS normal-equation solves for WRMF.

JAX replacement for the reference's per-row loop + MathNet dense
inverse (``WRMF.cs:79-156``): the Gram matrix HtH is one [f,I]x[I,f]
matmul; per-user systems are assembled from gathered, masked padded
histories and solved as one batch of f x f SPD systems by Cholesky
(``cho_factor``/``cho_solve``; replaces ``DenseMatrix.Inverse()``).

The per-user system (Hu/Koren/Volinsky implicit ALS, confidence
c = 1 + alpha on observed entries):
    W[u] = (HtH + alpha * H_S^T H_S + reg*I)^{-1} ((1+alpha) * sum_{i in S} H_i)

Users are processed in fixed-size chunks via lax.map so the gathered
[chunk, Lmax, f] temporary stays bounded.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import jax.scipy.linalg
import numpy as np


def _batched_spd_solve(M, b):
    """Batched SPD solve: one batched Cholesky factorisation and two
    triangular solves (cuSOLVER/cuBLAS on a GPU, LAPACK on the CPU).

    M: [C, f, f] SPD; b: [C, f]. Returns [C, f]."""
    factor = jax.scipy.linalg.cho_factor(M, lower=True)
    return jax.scipy.linalg.cho_solve(factor, b[..., None])[..., 0]


def _optimize_impl(H, hist, lens, alpha, reg, chunk: int):
    U, L = hist.shape
    f = H.shape[1]
    # Normal equations at HIGHEST precision: a TF32 Gram loses too many
    # digits for the Cholesky solve, and the f x f systems make the
    # extra cost negligible.
    hi = jax.lax.Precision.HIGHEST
    # [f, f] Gram over ALL items (reference WRMF.cs:94-108)
    HH = jnp.matmul(H.T, H, precision=hi)
    eye = jnp.eye(f, dtype=H.dtype)

    def solve_chunk(args):
        h, l = args                     # [C, L], [C]
        Hs = H[jnp.clip(h, 0, H.shape[0] - 1)]  # [C, L, f]
        mask = (jnp.arange(L)[None, :] < l[:, None]).astype(H.dtype)
        Hsm = Hs * mask[..., None]
        # alpha * H_S^T H_S  (reference HC_minus_IH, WRMF.cs:115-125)
        M = HH[None] + alpha * jnp.einsum(
            "clf,clg->cfg", Hsm, Hsm, precision=hi,
            preferred_element_type=jnp.float32) \
            + reg * eye[None]
        b = (1.0 + alpha) * jnp.sum(Hsm, axis=1)  # reference HCp :127-133
        return _batched_spd_solve(M, b)

    W = jax.lax.map(solve_chunk,
                    (hist.reshape(-1, chunk, L), lens.reshape(-1, chunk)))
    return W.reshape(U, f)


@functools.partial(jax.jit, static_argnames=("chunk",))
def wrmf_optimize(H, hist, lens, alpha, reg, *, chunk: int):
    """Solve all rows of W given the other side's factors H.

    H: [I, f] factors of the fixed side.
    hist: [U_pad, Lmax] int32 padded per-row histories (pad value
          arbitrary in-range; masked by lens). U_pad % chunk == 0.
    lens: [U_pad] int32 true history lengths.
    Returns W: [U_pad, f].
    """
    return _optimize_impl(H, hist, lens, alpha, reg, chunk)


@functools.lru_cache(maxsize=8)
def _wrmf_sharded_fn(mesh, chunk: int):
    """Mesh-sharded row solves: the reference's embarrassingly parallel
    Parallel.For over users (WRMF.cs:87-91) mapped onto the device mesh
    (SURVEY §2.9 P3). Rows (histories) shard over 'data'; the fixed-side
    factor table is replicated; each device batch-solves its rows."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def device_fn(H, hist, lens, alpha, reg):
        return _optimize_impl(H, hist, lens, alpha, reg, chunk)

    fn = shard_map(device_fn, mesh=mesh,
                   in_specs=(P(), P("data", None), P("data"), P(), P()),
                   out_specs=P("data", None))
    return jax.jit(fn)


def wrmf_optimize_sharded(mesh, H, hist, lens, alpha, reg, *, chunk: int):
    """Sharded wrmf_optimize. hist/lens must be row-sharded over the
    mesh's 'data' axis with rows % (devices * chunk) == 0; H replicated.
    Returns W row-sharded like hist."""
    return _wrmf_sharded_fn(mesh, chunk)(H, hist, lens, alpha, reg)


@functools.partial(jax.jit, static_argnames=("L",))
def _solve_row_impl(H, hist, length, alpha, reg, *, L: int):
    return _optimize_impl(H, hist[None, :], length[None], alpha, reg,
                          chunk=1)[0]


def wrmf_solve_row(H, item_ids: np.ndarray, alpha, reg):
    """Closed-form solve of ONE row against the fixed side's factors —
    the incremental-update primitive (reference WRMF.RetrainUser /
    RetrainItem, WRMF.cs:158-172: only the touched row is re-solved).
    History length is padded to a power of two to bound recompiles."""
    n = int(item_ids.size)
    L = max(1, 1 << (n - 1).bit_length()) if n else 1
    hist = np.zeros(L, np.int32)
    hist[:n] = item_ids
    return _solve_row_impl(H, jnp.asarray(hist), jnp.asarray(n, jnp.int32),
                           alpha, reg, L=L)


def pad_rows(hist: np.ndarray, lens: np.ndarray, chunk: int):
    """Pad the user dimension to a multiple of chunk (empty histories)."""
    U = hist.shape[0]
    U_pad = ((U + chunk - 1) // chunk) * chunk
    if U_pad == U:
        return hist, lens, U
    hist2 = np.zeros((U_pad, hist.shape[1]), dtype=hist.dtype)
    hist2[:U] = hist
    lens2 = np.zeros(U_pad, dtype=lens.dtype)
    lens2[:U] = lens
    return hist2, lens2, U
