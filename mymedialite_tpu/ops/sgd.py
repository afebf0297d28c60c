"""Jitted minibatch-SGD epoch kernels for the matrix-factorization family.

JAX replacement for the reference's sequential per-rating SGD
inner loops (``MatrixFactorization.cs:166-196``,
``BiasedMatrixFactorization.cs:264-309``) and its DSGD multicore
scheduler (``MultiCore.cs:43-73``): an epoch is a ``lax.scan`` over
minibatches; each minibatch gathers factor rows, computes the loss
gradient, and applies updates back into the tables. Duplicate user/item
ids within a minibatch sum their gradients (minibatch SGD) —
mathematically the same family of update as the reference's
block-parallel DSGD, validated by held-out quality rather than
bit-identical trajectories (SURVEY §7 'hard parts').

Design notes:
- the rating stream is shuffled ONCE on the host (the reference's cached
  ``RandomIndex``, DataSet.cs:100-108, is likewise shuffled once); per
  epoch only the batch-visit order is re-randomized, so batches are
  contiguous dynamic slices, not 20M-element on-device permutations;
- the flat epoch's batches carry host-precomputed dedup structures
  (unique sorted target rows + a segment id per example); the update is
  a ``segment_sum`` over examples followed by a scatter-add with
  ``indices_are_sorted=True, unique_indices=True``, instead of a
  ``.at[ids].add`` scatter with duplicate ids. Whether this still pays
  on a GPU, where duplicate scatter-adds are atomics, is unmeasured.
  Padding slots use out-of-range row ids which scatter-``drop``s.

All shapes are static: the rating arrays are padded to a multiple of the
batch size with weight-0 entries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Loss ids (reference OptimizationTarget enum, BiasedMatrixFactorization)
LOSS_RMSE = 0
LOSS_MAE = 1
LOSS_LOGISTIC = 2


def pad_to_batches(n: int, batch_size: int) -> int:
    return ((max(n, 1) + batch_size - 1) // batch_size) * batch_size


def _dedup_per_batch(ids: np.ndarray, batch_size: int, num_rows: int):
    """Per batch: sorted unique target rows (padded with out-of-range
    sentinels, which scatter-drop) and each example's slot index."""
    n = ids.shape[0]
    num_batches = n // batch_size
    slots = np.empty(n, dtype=np.int32)
    unique_ids = np.empty(n, dtype=np.int32)
    for b in range(num_batches):
        s = slice(b * batch_size, (b + 1) * batch_size)
        uniq, inv = np.unique(ids[s], return_inverse=True)
        k = uniq.shape[0]
        slots[s] = inv
        unique_ids[s][:k] = uniq
        # sentinels: strictly increasing, >= num_rows -> dropped by scatter
        unique_ids[s][k:] = num_rows + np.arange(batch_size - k)
    return slots, unique_ids


def prepare_epoch_data(users, items, values, batch_size: int,
                       shuffle_seed=0, num_users=None, num_items=None):
    """Shuffle (host-side, once), pad to a batch multiple, and precompute
    the per-batch dedup structures. Returns a device-ready dict."""
    n = len(users)
    users = np.asarray(users, dtype=np.int32)
    items = np.asarray(items, dtype=np.int32)
    values = np.asarray(values, dtype=np.float32)
    if shuffle_seed is not None and n > 1:
        perm = np.random.default_rng(shuffle_seed).permutation(n)
        users, items, values = users[perm], items[perm], values[perm]
    n_pad = pad_to_batches(n, batch_size)
    pad = n_pad - n
    users = np.concatenate([users, np.zeros(pad, np.int32)])
    items = np.concatenate([items, np.zeros(pad, np.int32)])
    values = np.concatenate([values, np.zeros(pad, np.float32)])
    weights = np.concatenate([np.ones(n, np.float32),
                              np.zeros(pad, np.float32)])
    U = num_users if num_users is not None else int(users.max()) + 1
    I = num_items if num_items is not None else int(items.max()) + 1
    u_slot, u_uniq = _dedup_per_batch(users, batch_size, U)
    i_slot, i_uniq = _dedup_per_batch(items, batch_size, I)
    return dict(
        users=jnp.asarray(users), items=jnp.asarray(items),
        values=jnp.asarray(values), weights=jnp.asarray(weights),
        user_slot=jnp.asarray(u_slot), user_uniq=jnp.asarray(u_uniq),
        item_slot=jnp.asarray(i_slot), item_uniq=jnp.asarray(i_uniq),
    )


def _gradient_common(loss: int, err, sig, rating_range):
    """The per-example common gradient factor (reference SetupLoss,
    BiasedMatrixFactorization.cs:246-261)."""
    if loss == LOSS_RMSE:
        return err * sig * (1.0 - sig) * rating_range
    if loss == LOSS_MAE:
        return jnp.sign(err) * sig * (1.0 - sig) * rating_range
    if loss == LOSS_LOGISTIC:
        return err
    raise ValueError(f"unknown loss {loss}")


def _dedup_scatter_add(table, slots, uniq_ids, per_example, batch_size: int):
    """segment-sum per-example updates by target row, then one sorted-unique
    scatter-add (out-of-range sentinel rows are dropped)."""
    seg = jax.ops.segment_sum(per_example, slots, num_segments=batch_size)
    return table.at[uniq_ids].add(
        seg, indices_are_sorted=True, unique_indices=True, mode="drop")


@functools.partial(
    jax.jit,
    static_argnames=("batch_size", "loss", "biased", "update_user",
                     "update_item", "frequency_regularization"),
    donate_argnames=("params",))
def sgd_epoch(params, data, key, hp, *, batch_size: int, loss: int,
              biased: bool, update_user: bool, update_item: bool,
              frequency_regularization: bool):
    """One pass over the (pre-shuffled) ratings.

    params: dict with 'user_factors' [U,f], 'item_factors' [I,f],
            'global_bias' scalar; if biased, also 'user_bias' [U],
            'item_bias' [I].
    data:   from prepare_epoch_data, plus (if frequency_regularization)
            'inv_sqrt_count_user' [U], 'inv_sqrt_count_item' [I].
    hp:     dict of f32 scalars: learn_rate, reg_u, reg_i, bias_reg,
            bias_learn_rate, min_rating, rating_range.
    """
    n_pad = data["users"].shape[0]
    num_batches = n_pad // batch_size
    # randomize only the batch-visit order per epoch (cheap)
    batch_order = jax.random.permutation(key, num_batches)

    lr = hp["learn_rate"]

    def batch_step(p, b):
        start = batch_order[b] * batch_size

        def sl(name):
            return jax.lax.dynamic_slice(data[name], (start,), (batch_size,))

        u, i, v, w = sl("users"), sl("items"), sl("values"), sl("weights")

        wu = p["user_factors"][u]  # [B, f]
        hi = p["item_factors"][i]  # [B, f]
        dot = jnp.sum(wu * hi, axis=-1)

        if biased:
            bu = p["user_bias"][u]
            bi = p["item_bias"][i]
            score = p["global_bias"] + bu + bi + dot
            sig = jax.nn.sigmoid(score)
            pred = hp["min_rating"] + sig * hp["rating_range"]
            err = v - pred
            g = _gradient_common(loss, err, sig, hp["rating_range"]) * w
        else:
            pred = p["global_bias"] + dot
            err = v - pred
            g = err * w

        if frequency_regularization:
            reg_u = hp["reg_u"] * data["inv_sqrt_count_user"][u]
            reg_i = hp["reg_i"] * data["inv_sqrt_count_item"][i]
        else:
            reg_u = jnp.full_like(g, hp["reg_u"])
            reg_i = jnp.full_like(g, hp["reg_i"])

        if update_user:
            u_slot, u_uniq = sl("user_slot"), sl("user_uniq")
            delta_w = lr * (g[:, None] * hi - (w * reg_u)[:, None] * wu)
            p["user_factors"] = _dedup_scatter_add(
                p["user_factors"], u_slot, u_uniq, delta_w, batch_size)
            if biased:
                delta_bu = hp["bias_learn_rate"] * lr * (
                    g - hp["bias_reg"] * reg_u * w * bu)
                p["user_bias"] = _dedup_scatter_add(
                    p["user_bias"], u_slot, u_uniq, delta_bu, batch_size)
        if update_item:
            i_slot, i_uniq = sl("item_slot"), sl("item_uniq")
            delta_h = lr * (g[:, None] * wu - (w * reg_i)[:, None] * hi)
            p["item_factors"] = _dedup_scatter_add(
                p["item_factors"], i_slot, i_uniq, delta_h, batch_size)
            if biased:
                delta_bi = hp["bias_learn_rate"] * lr * (
                    g - hp["bias_reg"] * reg_i * w * bi)
                p["item_bias"] = _dedup_scatter_add(
                    p["item_bias"], i_slot, i_uniq, delta_bi, batch_size)
        return p, None

    params, _ = jax.lax.scan(batch_step, params,
                             jnp.arange(num_batches, dtype=jnp.int32))
    return params


# ---------------------------------------------------------------------------
# blocked (slab) epoch — the single-device path of the MF family
# ---------------------------------------------------------------------------
#
# (1) Ratings are grouped by contiguous user-id ranges, so each group's
# user rows are gathered from and scattered to a small slab of the user
# table instead of the whole table; (2) biases are fused into the factor
# tables as two extra columns ([factors | b, 1] for users, [factors | 1,
# b] for items) so each side is ONE gather + ONE scatter instead of three
# of each; per-column learn-rate/reg vectors freeze the constant-1
# columns. Item updates use XLA's duplicate scatter-add. This is the
# reference's Gemulla-DSGD block idea (MultiCore.cs:43-73) on one device.

def prepare_blocked_data(users, items, values, num_users: int,
                         batch_size: int, group_users: int = 16_384,
                         shuffle_seed=0):
    """Group the rating stream by contiguous user-id ranges of
    ``group_users`` rows, shuffled within groups, padded rectangular."""
    n = len(users)
    users = np.asarray(users, dtype=np.int32)
    items = np.asarray(items, dtype=np.int32)
    values = np.asarray(values, dtype=np.float32)
    if shuffle_seed is not None and n > 1:
        perm = np.random.default_rng(shuffle_seed).permutation(n)
        users, items, values = users[perm], items[perm], values[perm]
    G = min(group_users, max(num_users, 1))
    ngroups = max((num_users + G - 1) // G, 1)
    group_of = users // G
    order = np.argsort(group_of, kind="stable")
    users, items, values = users[order], items[order], values[order]
    counts = np.bincount(group_of, minlength=ngroups)
    B = min(batch_size, pad_to_batches(int(counts.max()), 1))
    Lpad = pad_to_batches(int(counts.max()), B)
    gu = np.zeros((ngroups, Lpad), np.int32)
    gi = np.zeros((ngroups, Lpad), np.int32)
    gv = np.zeros((ngroups, Lpad), np.float32)
    gw = np.zeros((ngroups, Lpad), np.float32)
    off = np.concatenate([[0], np.cumsum(counts)])
    for g in range(ngroups):
        c = counts[g]
        gu[g, :c] = users[off[g]:off[g + 1]] - g * G
        gi[g, :c] = items[off[g]:off[g + 1]]
        gv[g, :c] = values[off[g]:off[g + 1]]
        gw[g, :c] = 1.0
    return dict(gu=jnp.asarray(gu), gi=jnp.asarray(gi),
                gv=jnp.asarray(gv), gw=jnp.asarray(gw)), \
        dict(ngroups=ngroups, group_users=G, batch=B, l_pad=Lpad)


def extend_tables(user_factors, item_factors, user_bias=None, item_bias=None,
                  group_users: int = 16_384):
    """Build the fused [factors | bias | one] tables. The user table is
    padded to a multiple of group_users."""
    W = np.asarray(user_factors, dtype=np.float32)
    H = np.asarray(item_factors, dtype=np.float32)
    U, f = W.shape
    G = min(group_users, max(U, 1))
    U_pad = max((U + G - 1) // G, 1) * G
    bu = np.zeros(U, np.float32) if user_bias is None else \
        np.asarray(user_bias, np.float32)
    bi = np.zeros(H.shape[0], np.float32) if item_bias is None else \
        np.asarray(item_bias, np.float32)
    We = np.zeros((U_pad, f + 2), np.float32)
    We[:U, :f] = W
    We[:U, f] = bu
    We[:, f + 1] = 1.0
    He = np.zeros((H.shape[0], f + 2), np.float32)
    He[:, :f] = H
    He[:, f] = 1.0
    He[:, f + 1] = bi
    return jnp.asarray(We), jnp.asarray(He)


def split_tables(W_ext, H_ext, num_users: int):
    """Inverse of extend_tables."""
    We = np.asarray(W_ext)[:num_users]
    He = np.asarray(H_ext)
    f = We.shape[1] - 2
    return We[:, :f], He[:, :f], We[:, f], He[:, f + 1]


def column_rates(num_factors: int, learn_rate, reg_u, reg_i, bias_learn_rate,
                 bias_reg, biased: bool, update_user: bool, update_item: bool):
    """Per-column learn-rate / regularization vectors for the fused
    tables; constant columns (and frozen sides) get rate 0."""
    f = num_factors
    lr, blr = float(learn_rate), float(bias_learn_rate)
    w_lr = np.array([lr] * f + [blr * lr if biased else 0.0, 0.0], np.float32)
    h_lr = np.array([lr] * f + [0.0, blr * lr if biased else 0.0], np.float32)
    w_reg = np.array([float(reg_u)] * f +
                     [float(bias_reg) * float(reg_u) if biased else 0.0, 0.0],
                     np.float32)
    h_reg = np.array([float(reg_i)] * f +
                     [0.0, float(bias_reg) * float(reg_i) if biased else 0.0],
                     np.float32)
    if not update_user:
        w_lr[:] = 0.0
    if not update_item:
        h_lr[:] = 0.0
    return (jnp.asarray(w_lr), jnp.asarray(w_reg),
            jnp.asarray(h_lr), jnp.asarray(h_reg))


@functools.partial(
    jax.jit,
    static_argnames=("meta", "loss", "biased", "frequency_regularization"),
    donate_argnames=("W_ext", "H_ext"))
def sgd_epoch_blocked(W_ext, H_ext, data, key, hp, rates, freq, *,
                      meta, loss: int, biased: bool,
                      frequency_regularization: bool):
    """One blocked pass. meta is the hashable tuple of prepare_blocked_data's
    meta dict. rates = (w_lr, w_reg, h_lr, h_reg) column vectors, already
    scaled by the CURRENT learn rate. freq = (inv_sqrt_count_user [U_pad],
    inv_sqrt_count_item [I]) or (None, None)."""
    m = dict(meta)
    G, B = m["group_users"], m["batch"]
    nb = m["l_pad"] // B
    fe = W_ext.shape[1]
    w_lr, w_reg, h_lr, h_reg = rates
    inv_cu, inv_ci = freq

    def group_step(carry, g):
        W, H = carry
        slab = jax.lax.dynamic_slice(W, (g * G, 0), (G, fe))
        border = jax.random.permutation(jax.random.fold_in(key, g), nb)

        def batch_step(inner, b):
            slab, H = inner
            start = border[b] * B
            u = jax.lax.dynamic_slice(data["gu"][g], (start,), (B,))
            i = jax.lax.dynamic_slice(data["gi"][g], (start,), (B,))
            v = jax.lax.dynamic_slice(data["gv"][g], (start,), (B,))
            w = jax.lax.dynamic_slice(data["gw"][g], (start,), (B,))
            wu = slab[u]
            hi = H[i]
            score = jnp.sum(wu * hi, axis=-1)  # includes b_u + b_i
            if biased:
                sig = jax.nn.sigmoid(score + hp["global_bias"])
                pred = hp["min_rating"] + sig * hp["rating_range"]
                err = v - pred
                g_com = _gradient_common(loss, err, sig,
                                         hp["rating_range"]) * w
            else:
                err = v - (score + hp["global_bias"])
                g_com = err * w
            if frequency_regularization:
                ru = inv_cu[u + g * G] * w
                ri = inv_ci[i] * w
            else:
                ru = w
                ri = w
            slab = slab.at[u].add(
                w_lr * (g_com[:, None] * hi - (w * ru)[:, None] * w_reg * wu))
            H = H.at[i].add(
                h_lr * (g_com[:, None] * wu - (w * ri)[:, None] * h_reg * hi))
            return (slab, H), None

        (slab, H), _ = jax.lax.scan(batch_step, (slab, H),
                                    jnp.arange(nb, dtype=jnp.int32))
        W = jax.lax.dynamic_update_slice(W, slab, (g * G, 0))
        return (W, H), None

    (W_ext, H_ext), _ = jax.lax.scan(
        group_step, (W_ext, H_ext),
        jnp.arange(m["ngroups"], dtype=jnp.int32))
    return W_ext, H_ext


@functools.partial(jax.jit, static_argnames=("loss", "biased",
                                             "frequency_regularization"))
def mf_objective(params, data, hp, counts, *, loss: int, biased: bool,
                 frequency_regularization: bool):
    """Training objective = loss sum + weighted L2 complexity
    (reference BiasedMatrixFactorization.ComputeObjective :515-552,
    MatrixFactorization's squared-error ComputeObjective). Used by the
    bold-driver learn-rate heuristic."""
    u, i, v, w = data["users"], data["items"], data["values"], data["weights"]
    wu = params["user_factors"][u]
    hi = params["item_factors"][i]
    dot = jnp.sum(wu * hi, axis=-1)
    if biased:
        score = params["global_bias"] + params["user_bias"][u] + \
            params["item_bias"][i] + dot
        sig = jax.nn.sigmoid(score)
        pred = hp["min_rating"] + sig * hp["rating_range"]
    else:
        pred = params["global_bias"] + dot

    if loss == LOSS_RMSE:
        loss_sum = jnp.sum(w * (v - pred) ** 2)
    elif loss == LOSS_MAE:
        loss_sum = jnp.sum(w * jnp.abs(v - pred))
    else:  # logistic, on [0,1]-normalized values
        a = (v - hp["min_rating"]) / hp["rating_range"]
        p01 = jnp.clip((pred - hp["min_rating"]) / hp["rating_range"],
                       1e-15, 1 - 1e-15)
        loss_sum = -jnp.sum(w * (a * jnp.log(p01) + (1 - a) * jnp.log1p(-p01)))

    cu = counts["count_user"].astype(jnp.float32)
    ci = counts["count_item"].astype(jnp.float32)
    if frequency_regularization:
        wu_reg = jnp.where(cu > 0, hp["reg_u"] / jnp.sqrt(jnp.maximum(cu, 1.0)), 0.0)
        wi_reg = jnp.where(ci > 0, hp["reg_i"] / jnp.sqrt(jnp.maximum(ci, 1.0)), 0.0)
    else:
        wu_reg = cu * hp["reg_u"]
        wi_reg = ci * hp["reg_i"]
    complexity = jnp.sum(wu_reg * jnp.sum(params["user_factors"] ** 2, axis=-1))
    complexity += jnp.sum(wi_reg * jnp.sum(params["item_factors"] ** 2, axis=-1))
    if biased:
        complexity += jnp.sum(wu_reg * hp["bias_reg"] * params["user_bias"] ** 2)
        complexity += jnp.sum(wi_reg * hp["bias_reg"] * params["item_bias"] ** 2)
    return loss_sum + complexity


# ---------------------------------------------------------------------------
# sharded blocked epoch — multi-chip DSGD
# ---------------------------------------------------------------------------
#
# The multi-chip mapping of the reference's Gemulla DSGD schedule
# (MultiCore.cs:43-73, BiasedMatrixFactorization.cs:206-215): user groups
# (contiguous id ranges = disjoint user-table slabs) are sharded across
# the 'data' mesh axis, so user updates are conflict-free by construction
# — exactly the reference's block-diagonal property, with mesh devices in
# place of threads. The item table is replicated; each device applies its
# group's item updates locally and the deltas are psum'd over ICI at each
# group boundary (sub-epoch minibatch semantics for H, like the
# reference's sub-epoch barriers).

def sgd_epoch_blocked_sharded(mesh, W_ext, H_ext, data, key, hp, rates,
                              freq, *, meta, loss: int, biased: bool,
                              frequency_regularization: bool):
    """Multi-device blocked epoch over a 1-D 'data' mesh.

    W_ext [ngroups*G, fe] must be row-sharded over 'data' with ngroups a
    multiple of the device count (pad with empty groups); H_ext
    replicated; the grouped data arrays sharded on their group axis.
    """
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    m = dict(meta)
    G, B = m["group_users"], m["batch"]
    nb = m["l_pad"] // B
    n_dev = mesh.devices.size
    if m["ngroups"] % n_dev != 0:
        raise ValueError("ngroups must be a multiple of the device count "
                         "(pad with empty groups)")
    groups_local = m["ngroups"] // n_dev
    fe = W_ext.shape[1]
    w_lr, w_reg, h_lr, h_reg = rates
    inv_cu, inv_ci = freq

    def device_fn(W_local, H, gu, gi, gv, gw, key):
        # W_local: [groups_local*G, fe]; data arrays [groups_local, Lpad]
        # H is replicated but updated device-locally inside the scan, so
        # mark it varying for the carry type
        H = jax.lax.pcast(H, "data", to="varying")

        def group_step(carry, g):
            W_loc, H = carry
            H_start = H
            slab = jax.lax.dynamic_slice(W_loc, (g * G, 0), (G, fe))
            border = jax.random.permutation(
                jax.random.fold_in(key, g), nb)

            def batch_step(inner, b):
                slab, H = inner
                start = border[b] * B
                u = jax.lax.dynamic_slice(gu[g], (start,), (B,))
                i = jax.lax.dynamic_slice(gi[g], (start,), (B,))
                v = jax.lax.dynamic_slice(gv[g], (start,), (B,))
                w = jax.lax.dynamic_slice(gw[g], (start,), (B,))
                wu = slab[u]
                hi = H[i]
                score = jnp.sum(wu * hi, axis=-1)
                if biased:
                    sig = jax.nn.sigmoid(score + hp["global_bias"])
                    pred = hp["min_rating"] + sig * hp["rating_range"]
                    err = v - pred
                    g_com = _gradient_common(loss, err, sig,
                                             hp["rating_range"]) * w
                else:
                    g_com = (v - (score + hp["global_bias"])) * w
                if frequency_regularization:
                    ru = inv_cu[u] * w  # local slab-relative counts
                    ri = inv_ci[i] * w
                else:
                    ru = w
                    ri = w
                slab = slab.at[u].add(
                    w_lr * (g_com[:, None] * hi
                            - (w * ru)[:, None] * w_reg * wu))
                H = H.at[i].add(
                    h_lr * (g_com[:, None] * wu
                            - (w * ri)[:, None] * h_reg * hi))
                return (slab, H), None

            (slab, H), _ = jax.lax.scan(batch_step, (slab, H),
                                        jnp.arange(nb, dtype=jnp.int32))
            W_loc = jax.lax.dynamic_update_slice(W_loc, slab, (g * G, 0))
            # merge the devices' item updates (DSGD sub-epoch barrier)
            H = H_start + jax.lax.psum(H - H_start, "data")
            return (W_loc, H), None

        (W_local, H), _ = jax.lax.scan(
            group_step, (W_local, H),
            jnp.arange(groups_local, dtype=jnp.int32))
        return W_local, H

    # H's final value is replicated by construction (every device ends on
    # H_start + psum(deltas)) but the varying-axis checker can't prove it,
    # hence check_vma=False.
    fn = shard_map(
        device_fn, mesh=mesh,
        in_specs=(P("data", None), P(), P("data", None), P("data", None),
                  P("data", None), P("data", None), P()),
        out_specs=(P("data", None), P()),
        check_vma=False)
    return jax.jit(fn)(W_ext, H_ext, data["gu"], data["gi"], data["gv"],
                       data["gw"], key)
