"""Correlation / similarity kernels, computed as dense matmuls.

JAX counterpart of the reference Correlation subsystem
(``Correlation/Overlap.cs:26-80``,
``BinaryDataSymmetricCorrelationMatrix.cs:25-100``, ``BinaryCosine.cs:35``,
``Jaccard.cs:30``, ``ConditionalProbability.cs:35``,
``BidirectionalConditionalProbability.cs:59``, ``Cooccurrence.cs:34``,
``Pearson.cs:58``, ``RatingCosine.cs:34``).

The reference computes all-pairs overlap by iterating the transpose
(O(nnz^2/rows)); here the same quantity is a matmul A @ A^T of
the binary incidence matrix, and the Pearson sufficient statistics are
five such matmuls. Correlation values match the reference formulas
exactly (diagonal forced to 1, the reference's zero-guards preserved).

Matmul precision: products of 0/1 (or small-int level) operands are
exact at the default precision on every backend (bf16/TF32 hold them
exactly, and counts stay below 2^24 in the f32 accumulator). Products
with arbitrary float32 operands (weighted overlap, raw rating values)
ask for HIGHEST, because a TF32 product would round them.

Two paths:

* the small-N path (``binary_correlation`` / ``rating_correlation``)
  materializes the full [N, N] correlation in one shot — exact
  reference storage semantics, used below ``DENSE_NMAX`` entities;
* the scale path (``binary_correlation_topk`` /
  ``rating_correlation_topk``) never materializes [N, N]: the incidence
  lives on device as one int8 [N, m] array (built by a device scatter
  from the COO stream), the Gram matrix is computed tile by tile
  ([row_chunk, col_chunk] per step), and each row keeps only a running
  top-k (value desc, id asc — the reference tie order from
  ``Correlation/Extensions.GetNearestNeighbors``) merged with
  ``lax.top_k``. Sweeping column chunks in ascending id order makes
  XLA TopK's lower-index-first tie-breaking reproduce the reference
  order with no extra sort. Rating correlations ride the same int8
  machinery by encoding the rating scale's (equally spaced) levels as
  small ints — Pearson is affine-invariant so the int-level statistics
  give the exact correlation, with exact int32 accumulation.
  This replaces the reference's transpose-iteration overlap counting
  (``Overlap.cs:26-80``) at shapes where a dense [N, N] is impossible
  (Netflix user-user: 480k^2 floats ~ 920 GB).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# above this many entities, KNN models switch to the streaming top-k path
DENSE_NMAX = 16_384


def incidence_dense(data, num_rows: int, num_cols: int,
                    values: np.ndarray = None) -> np.ndarray:
    """Dense [num_rows, num_cols] float32 matrix from COO interaction data
    (binary by default, or carrying rating values)."""
    M = np.zeros((num_rows, num_cols), dtype=np.float32)
    if values is None:
        M[data.users, data.items] = 1.0
    else:
        M[data.users, data.items] = values
    return M


@functools.partial(jax.jit, static_argnames=("kind",))
def _binary_correlation_from_incidence(A, alpha, *, kind: str):
    """All-pairs binary correlation of the rows of A (one chip, one shot)."""
    counts = jnp.sum(A, axis=1)                       # |x|
    overlap = jnp.dot(A, A.T, preferred_element_type=jnp.float32)  # 0/1
    return _map_overlap(overlap, counts, counts, alpha, kind)


def _map_overlap(overlap, cx, cy, alpha, kind: str):
    corr = _map_overlap_values(overlap, cx[:, None], cy[None, :], alpha, kind)
    n = corr.shape[0]
    eye = jnp.eye(n, dtype=bool)
    # the driver sets the diagonal to 1 before mapping
    # (BinaryDataSymmetricCorrelationMatrix.cs:48-50)
    return jnp.where(eye, 1.0, corr)


def _map_overlap_values(overlap, cx, cy, alpha, kind: str):
    """Overlap counts -> correlation values (no diagonal handling);
    cx/cy already broadcast-shaped."""
    if kind == "cosine":
        denom = jnp.sqrt(cx * cy)
        corr = jnp.where(denom > 0, overlap / jnp.maximum(denom, 1e-12), 0.0)
    elif kind == "jaccard":
        denom = cx + cy - overlap
        corr = jnp.where(overlap != 0, overlap / jnp.maximum(denom, 1e-12), 0.0)
    elif kind == "conditional_probability":
        corr = jnp.where(cx != 0, overlap / jnp.maximum(cx, 1e-12), 0.0)
    elif kind == "bidirectional_conditional_probability":
        ok = (cx != 0) & (cy != 0)
        x_given_y = overlap / jnp.maximum(cx, 1e-12)
        y_given_x = overlap / jnp.maximum(cy, 1e-12)
        corr = jnp.where(
            ok, x_given_y ** alpha * y_given_x ** (1.0 - alpha), 0.0)
    elif kind == "cooccurrence":
        corr = overlap
    else:
        raise ValueError(f"unknown binary correlation {kind!r}")
    return corr


def binary_correlation(data, num_entities: int, num_features: int,
                       kind: str = "cosine", alpha: float = 0.5,
                       weighted: bool = False) -> np.ndarray:
    """All-pairs correlation between entity rows of a binary matrix.

    data: InteractionData whose users are entities and items are features
          (e.g. PosOnlyData for user-user, its transpose for item-item,
          attribute data for attribute-based KNN).
    weighted: inverse-log-frequency feature weights
          (reference Overlap.ComputeWeighted, Overlap.cs:26-56).
    """
    A = incidence_dense(data, num_entities, num_features)
    if weighted:
        freq = A.sum(axis=0)
        w = (1.0 / np.log2(3.0 + freq)).astype(np.float32)
        Aw = jnp.asarray(A * w[None, :])
        overlap = jnp.dot(Aw, Aw.T, precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
        entity_weights = jnp.asarray(A @ w)
        corr = _map_overlap(overlap, entity_weights, entity_weights,
                            jnp.float32(alpha), kind)
        return np.asarray(corr)
    return np.asarray(_binary_correlation_from_incidence(
        jnp.asarray(A), jnp.float32(alpha), kind=kind))


@functools.partial(jax.jit, static_argnames=("centered",))
def _rating_correlation_kernel(R, B, shrinkage, *, centered: bool):
    """Pearson / RatingCosine sufficient statistics as matmuls.

    R: [N, M] ratings (0 where absent); B: [N, M] binary mask.
    Per pair (x, y) over co-rated features:
      n = B B^T, Sxy = R R^T, Sx = R B^T, Sxx = (R*R) B^T
    Pearson (Pearson.cs:224-242):
      (n*Sxy - Sx*Sy) / sqrt((n*Sxx - Sx^2)(n*Syy - Sy^2)) * (n-1)/(n-1+shrink)
    RatingCosine (RatingCosine.cs): Sxy / sqrt(Sxx*Syy), same shrinkage.
    """
    f32 = jnp.float32
    hi = jax.lax.Precision.HIGHEST
    n = jnp.dot(B, B.T, preferred_element_type=f32)
    Sxy = jnp.dot(R, R.T, precision=hi, preferred_element_type=f32)
    # sum of x over common
    Sx = jnp.dot(R, B.T, precision=hi, preferred_element_type=f32)
    Sy = Sx.T
    Sxx = jnp.dot(R * R, B.T, precision=hi, preferred_element_type=f32)
    Syy = Sxx.T
    if centered:
        num = n * Sxy - Sx * Sy
        den = jnp.sqrt(jnp.maximum((n * Sxx - Sx * Sx) * (n * Syy - Sy * Sy),
                                   0.0))
    else:
        num = Sxy
        den = jnp.sqrt(jnp.maximum(Sxx * Syy, 0.0))
    corr = jnp.where(den > 0, num / jnp.maximum(den, 1e-12), 0.0)
    corr = corr * ((n - 1.0) / (n - 1.0 + shrinkage))
    corr = jnp.where(n < 2, 0.0, corr)
    eye = jnp.eye(corr.shape[0], dtype=bool)
    return jnp.where(eye, 1.0, corr)


def rating_correlation(ratings, entity: str = "user", kind: str = "pearson",
                       shrinkage: float = 0.0) -> np.ndarray:
    """All-pairs Pearson/RatingCosine over a RatingData
    (reference Pearson.ComputeCorrelations)."""
    if entity == "user":
        R = incidence_dense(ratings, ratings.num_users, ratings.num_items,
                            ratings.values)
    else:
        t = type("T", (), {})()  # transpose view of the COO arrays
        t.users, t.items = ratings.items, ratings.users
        R = incidence_dense(t, ratings.num_items, ratings.num_users,
                            ratings.values)
    B = (R != 0).astype(np.float32)
    return np.asarray(_rating_correlation_kernel(
        jnp.asarray(R), jnp.asarray(B), jnp.float32(shrinkage),
        centered=(kind == "pearson")))


# ---------------------------------------------------------------------------
# streaming top-k correlation — the scale path (never materializes [N, N])
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_pad", "m"))
@functools.partial(jax.jit, static_argnames=("n_pad", "m"))
def _zeros_int8(*, n_pad: int, m: int):
    return jnp.zeros((n_pad, m), jnp.int8)


@functools.partial(jax.jit, static_argnames=("rows", "m"),
                   donate_argnames=("A",))
def _incidence_slab(A, lin, lev, row0, *, rows: int, m: int):
    # slice-accumulate-writeback with a FLAT 1-D scatter: linearized
    # per-slab indices are one [n] s32 array instead of an [n, 2] index
    # concat (slab_rows * m < 2^31 keeps them int32)
    S = jax.lax.dynamic_slice(A, (row0, 0), (rows, m))
    S = S.reshape(rows * m).at[lin].set(lev, mode="drop").reshape(rows, m)
    return jax.lax.dynamic_update_slice(A, S, (row0, 0))


_SLAB_EVENT_CHUNK = 1 << 21


def _device_incidence(entity_ids, feature_ids, levels, *, n_pad: int,
                      m: int, slab_rows: int = 65_536):
    """int8 [n_pad, m] incidence built by DONATED slab scatters
    (duplicate (entity, feature) pairs collapse, matching
    ``incidence_dense``). A single whole-table scatter does not alias
    its operand, so at the Netflix user-KNN shape (480k x 17.8k =
    8.6 GB) it would transiently need 2x the table; slab updates keep
    the peak at table + one ~1 GB slab. Slab height adapts to the
    feature width (the item-KNN orientation has m = 480k), and events
    scatter in bounded chunks that ACCUMULATE into the sliced slab."""
    eids = np.asarray(entity_ids)
    fids = np.asarray(feature_ids)
    lev = np.asarray(levels)
    if lev.ndim == 0:
        lev = np.full(eids.shape, lev, np.int8)
    A = _zeros_int8(n_pad=n_pad, m=m)
    # ~1 GB slab budget; keep linear indices within int32
    slab_rows = max(8, min(slab_rows, (1 << 30) // max(m, 1)))
    slab_rows = min(slab_rows, n_pad)
    sl = eids // slab_rows
    for s0 in range(0, n_pad, slab_rows):
        rows = min(slab_rows, n_pad - s0)
        idx = np.nonzero(sl == s0 // slab_rows)[0]
        if idx.size == 0:
            continue
        lin_all = (eids[idx].astype(np.int64) - s0) * m + fids[idx]
        for c0 in range(0, idx.size, _SLAB_EVENT_CHUNK):
            part = lin_all[c0:c0 + _SLAB_EVENT_CHUNK]
            # pow2 event capacity bounds recompiles; pads scatter
            # out-of-bounds and drop
            cap = 1 << max(int(part.size) - 1, 0).bit_length()
            lin = np.full(cap, rows * m, np.int64)
            l_pad = np.zeros(cap, lev.dtype)
            lin[:part.size] = part
            l_pad[:part.size] = lev[idx[c0:c0 + _SLAB_EVENT_CHUNK]]
            A = _incidence_slab(A, jnp.asarray(lin.astype(np.int32)),
                                jnp.asarray(l_pad), jnp.int32(s0),
                                rows=rows, m=m)
    return A


@functools.partial(jax.jit, static_argnames=("total",))
def _packed_scatter(byte_idx, mask, *, total: int):
    # deduped (byte, bit) pairs: each bit contributes once, so a
    # scatter-ADD is exactly a bitwise OR
    return jnp.zeros(total, jnp.uint8).at[byte_idx].add(mask, mode="drop")


def _packed_incidence(eids, fids, *, n_pad: int, m: int):
    """Bit-packed 0/1 incidence [n_pad, ceil(m/8)] uint8, built by ONE
    flat device scatter from host-deduplicated (byte, bit) pairs.

    The upload is the event stream (~5 B/event after dedup), not the
    table: at the Netflix item-KNN orientation that is 100 MB vs the
    8.6 GB int8 incidence or the 1.07 GB host-packed table. Returns
    (packed [n_pad, m8] uint8 on device, deduped bit-linear keys int64
    [nnz_unique] — reusable for per-entity counts)."""
    m8 = (m + 7) // 8
    mb = m8 * 8
    total = n_pad * m8
    if total >= (1 << 31):
        raise ValueError("packed incidence exceeds int32 indexing "
                         f"({total} bytes); shard the entity dim first")
    u = np.unique(np.asarray(eids, np.int64) * mb
                  + np.asarray(fids, np.int64))
    byte = (u >> 3).astype(np.int32)
    mask = (np.uint8(128) >> (u & 7).astype(np.uint8))  # MSB = col 8b+0
    # pow2 capacity bounds recompiles; pads scatter out-of-bounds + drop
    cap = 1 << max(int(u.size) - 1, 0).bit_length()
    b_pad = np.full(cap, total, np.int32)
    m_pad = np.zeros(cap, np.uint8)
    b_pad[:u.size] = byte
    m_pad[:u.size] = mask
    P = _packed_scatter(jnp.asarray(b_pad), jnp.asarray(m_pad),
                        total=total).reshape(n_pad, m8)
    return P, u


def _unpack_bits(P, dtype):
    """[R, m8] uint8 -> [R, m8*8] 0/1 in ``dtype`` ('big' bit order:
    the MSB of byte b is column 8*b)."""
    sh = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (P[:, :, None] >> sh[None, None, :]) & jnp.uint8(1)
    return bits.reshape(P.shape[0], -1).astype(dtype)


@functools.partial(jax.jit, static_argnames=("rows",),
                   donate_argnames=("A",))
def _unpack_slab(A, P, row0, *, rows: int):
    S = _unpack_bits(jax.lax.dynamic_slice(P, (row0, 0), (rows, P.shape[1])),
                     jnp.int8)
    return jax.lax.dynamic_update_slice(A, S, (row0, 0))


def _incidence_int8(eids, fids, *, n_pad: int, m: int):
    """int8 0/1 incidence [n_pad, mb] (mb = m rounded up to 8; the pad
    columns stay zero), built scatter-free from the bit-packed incidence
    in one device pass: it uploads ~5 B/event and unpacks slabs with
    elementwise ops. Returns
    (A int8 [n_pad, mb], deduped bit-linear pair keys int64)."""
    P, u = _packed_incidence(eids, fids, n_pad=n_pad, m=m)
    mb = P.shape[1] * 8
    A = jnp.zeros((n_pad, mb), jnp.int8)
    slab = max(1, min(n_pad, (1 << 28) // max(mb, 1)))
    for r0 in range(0, n_pad, slab):
        rows = min(slab, n_pad - r0)
        A = _unpack_slab(A, P, jnp.int32(r0), rows=rows)
    return A, u


def _merge_topk(vals, ids, tile_vals, tile_ids, k: int):
    """Merge the running per-row top-k with a tile's top-k. The running
    entries come from lower column ids and are concatenated first, so
    XLA TopK's lower-index-first tie rule keeps the reference order
    (correlation desc, id asc)."""
    mv, mi = jax.lax.top_k(jnp.concatenate([vals, tile_vals], axis=1), k)
    mids = jnp.take_along_axis(
        jnp.concatenate([ids, tile_ids], axis=1), mi, axis=1)
    return mv, mids


@functools.partial(jax.jit,
                   static_argnames=("kind", "k", "chunk", "n", "weighted"))
def _topk_chunk_binary(A, cnt, w, row_start, alpha, *, kind: str, k: int,
                       chunk: int, n: int, weighted: bool):
    """Running top-k correlations for one block of rows against all
    columns, sweeping column chunks in ascending id order."""
    m = A.shape[1]
    R = C = chunk
    A_r = jax.lax.dynamic_slice(A, (row_start, 0), (R, m))
    if weighted:
        A_rw = A_r.astype(jnp.float32) * w[None, :]
    rid = row_start + jnp.arange(R, dtype=jnp.int32)
    cnt_r = jax.lax.dynamic_slice(cnt, (row_start,), (R,))
    nc = A.shape[0] // C

    def body(c, state):
        col_start = c * C
        A_c = jax.lax.dynamic_slice(A, (col_start, 0), (C, m))
        if weighted:
            ov = jnp.dot(A_rw, (A_c.astype(jnp.float32) * w[None, :]).T,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        else:
            # convert PER TILE (0/1 exact in bf16; overlap <= m < 2^24
            # exact in the f32 accumulator, so exact at any precision):
            # an int8 x int8 -> int32 dot tempts XLA to hoist a
            # whole-table upcast out of the column loop, which at the
            # Netflix user-KNN shape would materialize a 34 GB copy of
            # the 8.6 GB incidence
            ov = jnp.dot(A_r.astype(jnp.bfloat16),
                         A_c.astype(jnp.bfloat16).T,
                         preferred_element_type=jnp.float32)
        cnt_c = jax.lax.dynamic_slice(cnt, (col_start,), (C,))
        corr = _map_overlap_values(ov, cnt_r[:, None], cnt_c[None, :],
                                   alpha, kind)
        cid = col_start + jnp.arange(C, dtype=jnp.int32)
        bad = (cid[None, :] >= n) | (cid[None, :] == rid[:, None])
        corr = jnp.where(bad, -jnp.inf, corr)
        return _merge_topk_if_competitive(state, corr, col_start, k)

    init = (jnp.full((R, k), -jnp.inf, jnp.float32),
            jnp.full((R, k), jnp.int32(0), jnp.int32))
    return jax.lax.fori_loop(0, nc, body, init)


def _merge_topk_if_competitive(state, corr, col_start, k: int):
    """Exact top-k skip: the [R, C] top_k + merge can cost more than
    the Gram tile itself, and once the running
    k-th values are high most tiles cannot contribute — a tile whose
    per-row max is <= the running k-th value for EVERY row leaves the
    state unchanged (on exact ties the merge keeps the RUNNING entry:
    it is concatenated first and XLA TopK keeps the lower index, which
    is also the reference's lower-id tie rule), so it is skipped with
    one scalar-predicated lax.cond."""
    cannot_contribute = jnp.all(
        jnp.max(corr, axis=1) <= state[0][:, -1])

    def merge(s):
        tv, ti = jax.lax.top_k(corr, k)
        return _merge_topk(*s, tv, col_start + ti.astype(jnp.int32), k)

    return jax.lax.cond(cannot_contribute, lambda s: s, merge, state)


@functools.partial(jax.jit,
                   static_argnames=("centered", "k", "chunk", "n"))
def _topk_chunk_rating(L, row_start, shrinkage, *, centered: bool, k: int,
                       chunk: int, n: int):
    """Running top-k Pearson/RatingCosine for one block of rows.

    L is int8 rating *levels* (0 = absent) when the scale is equally
    spaced — Pearson is affine-invariant and RatingCosine scale-invariant,
    so level statistics give the exact correlation with exact int32
    accumulation — or float32 raw values otherwise.
    """
    m = L.shape[1]
    R = C = chunk
    int_path = L.dtype == jnp.int8
    L_r = jax.lax.dynamic_slice(L, (row_start, 0), (R, m))
    rid = row_start + jnp.arange(R, dtype=jnp.int32)
    nc = L.shape[0] // C

    def stats(L_r, B_r, L_c, B_c):
        if int_path:
            i32 = jnp.int32
            nn = jnp.dot(B_r, B_c.T, preferred_element_type=i32)
            Sxy = jnp.dot(L_r, L_c.T, preferred_element_type=i32)
            Sx = jnp.dot(L_r, B_c.T, preferred_element_type=i32)
            Sy = jnp.dot(B_r, L_c.T, preferred_element_type=i32)
            # L*L can exceed int8: split l^2 = hi*128 + lo (l <= 127)
            Lsq = L_r.astype(i32) * L_r.astype(i32)
            hi = (Lsq >> 7).astype(jnp.int8)
            lo = (Lsq & 127).astype(jnp.int8)
            Sxx = (jnp.dot(hi, B_c.T, preferred_element_type=i32) << 7) \
                + jnp.dot(lo, B_c.T, preferred_element_type=i32)
            Lsq_c = L_c.astype(i32) * L_c.astype(i32)
            hi_c = (Lsq_c >> 7).astype(jnp.int8)
            lo_c = (Lsq_c & 127).astype(jnp.int8)
            Syy = (jnp.dot(B_r, hi_c.T, preferred_element_type=i32) << 7) \
                + jnp.dot(B_r, lo_c.T, preferred_element_type=i32)
            return tuple(x.astype(jnp.float32)
                         for x in (nn, Sxy, Sx, Sy, Sxx, Syy))
        f32 = jnp.float32
        hi = jax.lax.Precision.HIGHEST
        nn = jnp.dot(B_r, B_c.T, preferred_element_type=f32)
        Sxy = jnp.dot(L_r, L_c.T, precision=hi, preferred_element_type=f32)
        Sx = jnp.dot(L_r, B_c.T, precision=hi, preferred_element_type=f32)
        Sy = jnp.dot(B_r, L_c.T, precision=hi, preferred_element_type=f32)
        Sxx = jnp.dot(L_r * L_r, B_c.T, precision=hi,
                      preferred_element_type=f32)
        Syy = jnp.dot(B_r, (L_c * L_c).T, precision=hi,
                      preferred_element_type=f32)
        return nn, Sxy, Sx, Sy, Sxx, Syy

    if int_path:
        B_r = (L_r != 0).astype(jnp.int8)
    else:
        B_r = (L_r != 0).astype(jnp.float32)

    def body(c, state):
        col_start = c * C
        L_c = jax.lax.dynamic_slice(L, (col_start, 0), (C, m))
        B_c = (L_c != 0).astype(L_c.dtype if not int_path else jnp.int8)
        nn, Sxy, Sx, Sy, Sxx, Syy = stats(L_r, B_r, L_c, B_c)
        # same formula as _rating_correlation_kernel (Pearson.cs:224-242)
        if centered:
            num = nn * Sxy - Sx * Sy
            den = jnp.sqrt(jnp.maximum(
                (nn * Sxx - Sx * Sx) * (nn * Syy - Sy * Sy), 0.0))
        else:
            num = Sxy
            den = jnp.sqrt(jnp.maximum(Sxx * Syy, 0.0))
        corr = jnp.where(den > 0, num / jnp.maximum(den, 1e-12), 0.0)
        corr = corr * ((nn - 1.0) / (nn - 1.0 + shrinkage))
        corr = jnp.where(nn < 2, 0.0, corr)
        cid = col_start + jnp.arange(C, dtype=jnp.int32)
        bad = (cid[None, :] >= n) | (cid[None, :] == rid[:, None])
        corr = jnp.where(bad, -jnp.inf, corr)
        return _merge_topk_if_competitive(state, corr, col_start, k)

    init = (jnp.full((R, k), -jnp.inf, jnp.float32),
            jnp.full((R, k), jnp.int32(0), jnp.int32))
    return jax.lax.fori_loop(0, nc, body, init)


def _run_topk_chunks(kernel, n: int, chunk: int, k_eff: int):
    """Drive a per-row-chunk kernel over all rows, collecting host arrays."""
    out_vals = np.empty((n, k_eff), np.float32)
    out_ids = np.empty((n, k_eff), np.int32)
    for r0 in range(0, n, chunk):
        v, i = kernel(jnp.int32(r0))
        take = min(chunk, n - r0)
        out_vals[r0:r0 + take] = np.asarray(v)[:take]
        out_ids[r0:r0 + take] = np.asarray(i)[:take]
    return out_ids, out_vals


def binary_correlation_topk(data, num_entities: int, num_features: int,
                            k: int, kind: str = "cosine", alpha: float = 0.5,
                            weighted: bool = False, chunk: int = 4096):
    """Per-row top-k binary correlations without materializing [N, N].

    Returns (neighbor_ids [n, k_eff] int32, values [n, k_eff] float32) in
    the reference neighbor order (correlation desc, id asc — matches
    ``nearest_neighbors`` on the dense matrix). Scales to Netflix-shape
    user-user KNN (480k entities) on one chip: the int8 incidence is
    ~n*m bytes on device and each step touches one [chunk, chunk] tile.
    """
    n, m = num_entities, num_features
    k_eff = min(k, n - 1) if k >= 0 else n - 1
    if k_eff <= 0:
        return (np.zeros((n, 0), np.int32), np.zeros((n, 0), np.float32))
    # cap the tile height so the two per-tile bf16 converts stay ~1 GB
    # each: the item-KNN orientation has m = num_users (480k at Netflix
    # scale), where chunk=4096 tiles would transiently need 2 x 3.9 GB
    # on top of the 8.6 GB incidence
    if m > 0:
        chunk = min(chunk, max(512, ((1 << 29) // m) // 256 * 256))
    chunk = int(min(max(chunk, k_eff), n))
    n_pad = ((n + chunk - 1) // chunk) * chunk
    eids = np.asarray(data.users, dtype=np.int32)
    fids = np.asarray(data.items, dtype=np.int32)
    A, pairs = _incidence_int8(eids, fids, n_pad=n_pad, m=m)
    m_bits = A.shape[1]
    ue, uf = pairs // m_bits, pairs % m_bits
    if weighted:
        # inverse-log frequency weights (Overlap.ComputeWeighted,
        # Overlap.cs:26-56); O(nnz) host bincounts over the deduped
        # (entity, feature) pairs from the incidence build
        freq = np.bincount(uf, minlength=m)
        w_host = (1.0 / np.log2(3.0 + freq)).astype(np.float32)
        cnt = jnp.asarray(np.bincount(
            ue, weights=w_host[uf].astype(np.float64),
            minlength=n_pad).astype(np.float32))
        w = jnp.asarray(np.pad(w_host[:m], (0, m_bits - m)))
    else:
        w = jnp.zeros(m_bits, jnp.float32)
        cnt = jnp.asarray(np.bincount(ue, minlength=n_pad)
                          .astype(np.float32))

    def kernel(r0):
        return _topk_chunk_binary(A, cnt, w, r0, jnp.float32(alpha),
                                  kind=kind, k=k_eff, chunk=chunk, n=n,
                                  weighted=weighted)

    return _run_topk_chunks(kernel, n, chunk, k_eff)


def _quantize_levels(values: np.ndarray, centered: bool):
    """Encode ratings as small-int levels when the scale allows the exact
    int8 path: Pearson is affine-invariant (any equally spaced scale),
    RatingCosine scale-invariant (values must be integer multiples of the
    spacing). Returns int levels >= 1, or None to use float32."""
    uniq = np.unique(values)
    if uniq.size < 2:
        return np.ones_like(values, dtype=np.int8) if uniq.size else None
    s = float(np.min(np.diff(uniq)))
    if s <= 0:
        return None
    if centered:
        lev = np.round((values - uniq[0]) / s) + 1
        exact = np.allclose(uniq[0] + (lev - 1) * s, values, atol=1e-9)
    else:
        lev = np.round(values / s)
        exact = np.allclose(lev * s, values, atol=1e-9) and lev.min() >= 1
    if not exact or lev.max() > 127:
        return None
    return lev.astype(np.int8)


def rating_correlation_topk(ratings, k: int, entity: str = "user",
                            kind: str = "pearson", shrinkage: float = 0.0,
                            chunk: int = 4096):
    """Per-row top-k Pearson/RatingCosine without materializing [N, N]
    (scale path of ``rating_correlation``)."""
    if entity == "user":
        eids, fids = ratings.users, ratings.items
        n, m = ratings.num_users, ratings.num_items
    else:
        eids, fids = ratings.items, ratings.users
        n, m = ratings.num_items, ratings.num_users
    k_eff = min(k, n - 1) if k >= 0 else n - 1
    if k_eff <= 0:
        return (np.zeros((n, 0), np.int32), np.zeros((n, 0), np.float32))
    chunk = int(min(max(chunk, k_eff), n))
    n_pad = ((n + chunk - 1) // chunk) * chunk
    centered = kind == "pearson"
    values = np.asarray(ratings.values, dtype=np.float64)
    eids = np.asarray(eids, dtype=np.int32)
    fids = np.asarray(fids, dtype=np.int32)
    # duplicate (entity, feature) pairs: keep the last occurrence, matching
    # incidence_dense's numpy assignment (device scatter order is not
    # deterministic for duplicates)
    key = eids.astype(np.int64) * m + fids
    _, idx_rev = np.unique(key[::-1], return_index=True)
    sel = len(key) - 1 - idx_rev
    eids, fids, values = eids[sel], fids[sel], values[sel]
    lev = _quantize_levels(values, centered)
    eids_d = jnp.asarray(eids)
    fids_d = jnp.asarray(fids)
    if lev is not None:
        L = _device_incidence(eids_d, fids_d, jnp.asarray(lev),
                              n_pad=n_pad, m=m)
    else:
        L = jnp.zeros((n_pad, m), jnp.float32).at[eids_d, fids_d].set(
            jnp.asarray(values.astype(np.float32)), mode="drop")

    def kernel(r0):
        return _topk_chunk_rating(L, r0, jnp.float32(shrinkage),
                                  centered=centered, k=k_eff, chunk=chunk,
                                  n=n)

    return _run_topk_chunks(kernel, n, chunk, k_eff)


def nearest_neighbors(corr: np.ndarray, k: int) -> np.ndarray:
    """Per-row top-k neighbor ids by descending correlation, self excluded
    (reference Correlation/Extensions.GetNearestNeighbors :153-175).
    Ties broken by ascending id. Returns [N, min(k, N-1)] int32."""
    n = corr.shape[0]
    c = corr.copy()
    np.fill_diagonal(c, -np.inf)
    k_eff = min(k, n - 1) if k >= 0 else n - 1
    if k_eff <= 0:
        return np.zeros((n, 0), dtype=np.int32)
    # stable sort so boundary ties resolve to ascending id, like the
    # streaming top-k kernels (argpartition would pick an arbitrary
    # subset of tied boundary entries)
    return np.argsort(-c, axis=1, kind="stable")[:, :k_eff].astype(np.int32)
