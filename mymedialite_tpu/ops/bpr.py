"""Jitted BPR (Bayesian Personalized Ranking) training epochs with
on-device triple sampling.

JAX replacement for the reference's per-triple loop
(``BPRMF.cs:152-374``): the CPU code rejection-samples negatives against
a per-user HashSet with unbounded retries (``BPRMF.cs:279-284``) — not
expressible in XLA. Here:

- user histories live in a device-resident CSR (flat sorted item array +
  row pointers), membership tests are fixed-depth vectorized binary
  searches within a user's segment;
- negative sampling draws a fixed number of uniform trials per triple
  and takes the first non-positive (failure probability density^T,
  ~1e-10 at T=8 on MovieLens-like densities; failed triples get update
  weight 0);
- an epoch is a lax.scan over minibatches of triples; updates are
  scatter-adds (duplicate ids within a batch sum, i.e. minibatch SGD).

Sampling regimes (reference BPRMF.cs:183-321):
- uniform-user (default): user ~ Uniform(users with 0 < |I_u| < I),
  positive ~ Uniform(I_u), negative ~ Uniform(I \\ I_u)
- uniform-pair: (u, i) ~ Uniform(feedback events) — with replacement
  (iid) or without (a per-epoch permutation of events)
- WBPR (WeightedBPRMF.cs:55-66): (u,i) ~ Uniform(events) (users by
  activity), negative ~ popularity, rejected against I_u
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

UNIFORM_USER = 0
UNIFORM_PAIR = 1
UNIFORM_PAIR_WOR = 2   # without replacement: permutation of events
WBPR = 3


def make_sampler_data(feedback, num_neg_trials: int = 8):
    """Device-resident sampling state built from a PosOnlyData."""
    csr = feedback.by_user
    counts = csr.counts()
    num_items = feedback.num_items
    valid = np.nonzero((counts > 0) & (counts < num_items))[0].astype(np.int32)
    if valid.size == 0:
        valid = np.zeros(1, dtype=np.int32)
    max_count = int(counts.max()) if counts.size else 1
    search_depth = max(int(np.ceil(np.log2(max(max_count, 1) + 1))) + 1, 1)
    return dict(
        hist_items=jnp.asarray(csr.keys),            # [nnz] sorted per segment
        indptr=jnp.asarray(csr.indptr.astype(np.int32)),  # [U+1]
        counts=jnp.asarray(counts.astype(np.int32)),
        valid_users=jnp.asarray(valid),
        users=jnp.asarray(feedback.users),           # COO (for pair sampling)
        items=jnp.asarray(feedback.items),
    ), dict(num_items=num_items, num_users=feedback.num_users,
            num_events=len(feedback), num_neg_trials=num_neg_trials,
            search_depth=search_depth)


def _segment_contains(hist_items, indptr, users, keys, depth: int):
    """Vectorized membership test: is keys[k] in the sorted history segment
    of users[k]? Fixed-depth binary search (XLA-friendly)."""
    lo = indptr[users]
    hi = indptr[users + 1]

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        # clamp so the gather is always in range, even when lo == hi
        v = hist_items[jnp.minimum(mid, hist_items.shape[0] - 1)]
        go_right = (v < keys) & (lo < hi)
        new_lo = jnp.where(go_right, mid + 1, lo)
        new_hi = jnp.where(go_right | (lo >= hi), hi, mid)
        return new_lo, new_hi

    lo, hi = jax.lax.fori_loop(0, depth, body, (lo, hi))
    at = jnp.minimum(lo, hist_items.shape[0] - 1)
    return (lo < indptr[users + 1]) & (hist_items[at] == keys)


def _sample_negatives(key, sampler, users, num_items, trials: int, depth: int,
                      pop_cdf=None):
    """Fixed-trial rejection sampling of negatives for a batch of users.
    Returns (neg_items, ok_mask)."""
    B = users.shape[0]
    if pop_cdf is None:
        cand = jax.random.randint(key, (trials, B), 0, num_items, dtype=jnp.int32)
    else:
        u01 = jax.random.uniform(key, (trials, B))
        cand = jnp.searchsorted(pop_cdf, u01).astype(jnp.int32)
        cand = jnp.minimum(cand, num_items - 1)
    is_pos = jax.vmap(
        lambda c: _segment_contains(sampler["hist_items"], sampler["indptr"],
                                    users, c, depth))(cand)  # [T, B]
    good = ~is_pos
    first = jnp.argmax(good, axis=0)                     # [B]
    ok = jnp.any(good, axis=0)
    neg = cand[first, jnp.arange(B)]
    return neg, ok


def _sample_triples(key, sampler, meta, batch_size: int, regime: int,
                    perm=None, batch_index=None, pop_cdf=None):
    """Sample a batch of (u, i, j, weight) BPR triples on device."""
    k_u, k_i, k_j = jax.random.split(key, 3)
    num_items = meta["num_items"]
    if regime == UNIFORM_USER:
        uidx = jax.random.randint(k_u, (batch_size,), 0,
                                  sampler["valid_users"].shape[0],
                                  dtype=jnp.int32)
        u = sampler["valid_users"][uidx]
        r = jax.random.randint(k_i, (batch_size,), 0, jnp.iinfo(jnp.int32).max,
                               dtype=jnp.int32)
        pos_off = r % jnp.maximum(sampler["counts"][u], 1)
        i = sampler["hist_items"][sampler["indptr"][u] + pos_off]
    elif regime in (UNIFORM_PAIR, WBPR):
        eidx = jax.random.randint(k_u, (batch_size,), 0, meta["num_events"],
                                  dtype=jnp.int32)
        u = sampler["users"][eidx]
        i = sampler["items"][eidx]
    else:  # UNIFORM_PAIR_WOR: slice of a per-epoch permutation
        eidx = jax.lax.dynamic_slice(perm, (batch_index * batch_size,),
                                     (batch_size,))
        u = sampler["users"][eidx]
        i = sampler["items"][eidx]
    j, ok = _sample_negatives(
        k_j, sampler, u, num_items, meta["num_neg_trials"],
        meta["search_depth"], pop_cdf=pop_cdf if regime == WBPR else None)
    w = ok.astype(jnp.float32)
    if regime == UNIFORM_PAIR_WOR:
        # padding beyond the true event count gets weight 0
        w = w * (jax.lax.dynamic_slice(perm, (batch_index * batch_size,),
                                       (batch_size,)) < meta["num_events"]
                 ).astype(jnp.float32)
    return u, i, j, w


@functools.partial(
    jax.jit,
    static_argnames=("batch_size", "num_batches", "regime", "meta_static",
                     "update_j", "soft_margin"),
    donate_argnames=("params",))
def bpr_epoch(params, sampler, key, hp, pop_cdf, *, batch_size: int,
              num_batches: int, regime: int, meta_static, update_j: bool,
              soft_margin: bool = False):
    """One epoch = num_batches minibatches of sampled triples.

    params: user_factors [U,f], item_factors [I,f], item_bias [I].
    hp: f32 scalars learn_rate, reg_u, reg_i, reg_j, bias_reg.
    meta_static: hashable tuple from make_sampler_data's meta dict.
    soft_margin: hinge gradient (SoftMarginRankingMF.cs:52-110) instead
    of the BPR sigmoid.
    """
    meta = dict(meta_static)
    lr = hp["learn_rate"]

    n_pad = num_batches * batch_size
    if regime == UNIFORM_PAIR_WOR:
        # permutation over padded event indices; pad entries masked later
        perm = jax.random.permutation(
            jax.random.fold_in(key, 0x5eed),
            jnp.arange(n_pad, dtype=jnp.int32))
    else:
        perm = None

    def batch_step(p, b):
        bkey = jax.random.fold_in(key, b)
        u, i, j, w = _sample_triples(bkey, sampler, meta, batch_size, regime,
                                     perm=perm, batch_index=b, pop_cdf=pop_cdf)
        wu = p["user_factors"][u]
        hi = p["item_factors"][i]
        hj = p["item_factors"][j]
        x_uij = p["item_bias"][i] - p["item_bias"][j] + \
            jnp.sum(wu * (hi - hj), axis=-1)
        if soft_margin:
            # hinge: gradient 1 on margin violation (x_uij < 1), else 0
            g = jnp.where(x_uij < 1.0, 1.0, 0.0) * w
        else:
            g = jax.nn.sigmoid(-x_uij) * w  # = 1/(1+e^x)
        # factor updates (reference UpdateFactors, BPRMF.cs:330-374)
        p["user_factors"] = p["user_factors"].at[u].add(
            lr * (g[:, None] * (hi - hj) - (w * hp["reg_u"])[:, None] * wu))
        p["item_factors"] = p["item_factors"].at[i].add(
            lr * (g[:, None] * wu - (w * hp["reg_i"])[:, None] * hi))
        p["item_bias"] = p["item_bias"].at[i].add(
            lr * (g - hp["bias_reg"] * w * p["item_bias"][i]))
        if update_j:
            p["item_factors"] = p["item_factors"].at[j].add(
                lr * (-g[:, None] * wu - (w * hp["reg_j"])[:, None] * hj))
            p["item_bias"] = p["item_bias"].at[j].add(
                lr * (-g - hp["bias_reg"] * w * p["item_bias"][j]))
        return p, None

    params, _ = jax.lax.scan(batch_step, params,
                             jnp.arange(num_batches, dtype=jnp.int32))
    return params


@jax.jit
def bpr_objective(params, hp, loss_u, loss_i, loss_j):
    """Approximate BPR-Opt objective on a fixed triple sample (reference
    convergence tracking, BPRMF.cs:135-150): ranking loss ln(1+e^{-x})
    plus L2 complexity of the touched rows."""
    wu = params["user_factors"][loss_u]
    hi = params["item_factors"][loss_i]
    hj = params["item_factors"][loss_j]
    x = params["item_bias"][loss_i] - params["item_bias"][loss_j] + \
        jnp.sum(wu * (hi - hj), axis=-1)
    ranking_loss = jnp.sum(jnp.log1p(jnp.exp(-x)))
    complexity = (hp["reg_u"] * jnp.sum(wu ** 2)
                  + hp["reg_i"] * jnp.sum(hi ** 2)
                  + hp["reg_j"] * jnp.sum(hj ** 2)
                  + hp["bias_reg"] * jnp.sum(params["item_bias"][loss_i] ** 2)
                  + hp["bias_reg"] * jnp.sum(params["item_bias"][loss_j] ** 2))
    return ranking_loss + complexity


def popularity_cdf(feedback) -> jnp.ndarray:
    """Cumulative item-popularity distribution for WBPR negative sampling
    (reference WeightedBPRMF.cs: negatives proportional to popularity)."""
    counts = feedback.count_by_item.astype(np.float64)
    total = counts.sum()
    if total == 0:
        counts = np.ones_like(counts)
        total = counts.sum()
    return jnp.asarray(np.cumsum(counts / total), dtype=jnp.float32)


# ---------------------------------------------------------------------------
# mesh-sharded BPR epoch — multi-chip data parallelism
# ---------------------------------------------------------------------------
#
# The mesh counterpart of the reference's MultiCoreBPRMF (MultiCoreBPRMF.cs:30,
# Parallel.ForEach over PartitionIndices blocks, hogwild updates): users
# are partitioned into contiguous ranges, one per device; each device
# samples triples FOR ITS OWN USERS on-device (per-device fold_in key) so
# user-factor updates are conflict-free by construction (stronger than
# the reference's tolerated races); item-factor/bias deltas are merged
# with a psum after every minibatch (sub-epoch barrier = minibatch SGD
# over the devices' combined batch).

def make_sampler_data_sharded(feedback, n_devices: int,
                              num_neg_trials: int = 8):
    """Per-device sampling state, stacked on a leading device axis.

    Users are split into n_devices contiguous ranges of the padded user
    space. Ragged per-device arrays (histories, valid-user lists, event
    lists) are padded to the max; valid/event lists pad by cycling their
    real entries (near-uniform sampling), with weight-0 fallbacks for
    devices that own no data.
    """
    csr = feedback.by_user
    counts_g = csr.counts()
    U, I = feedback.num_users, feedback.num_items
    U_loc = max(-(-U // n_devices), 1)

    hist_list, indptr_list, counts_list, valid_list = [], [], [], []
    ev_u_list, ev_i_list = [], []
    users_g = np.asarray(feedback.users)
    items_g = np.asarray(feedback.items)
    order = np.argsort(users_g, kind="stable")
    users_s, items_s = users_g[order], items_g[order]
    bounds = np.searchsorted(users_s, np.arange(n_devices + 1) * U_loc)
    for d in range(n_devices):
        lo_u, hi_u = d * U_loc, min((d + 1) * U_loc, U)
        n_u = max(hi_u - lo_u, 0)
        cnt = np.zeros(U_loc, dtype=np.int32)
        if n_u > 0:
            cnt[:n_u] = counts_g[lo_u:hi_u]
        indptr = np.zeros(U_loc + 1, dtype=np.int32)
        np.cumsum(cnt, out=indptr[1:])
        lo_e, hi_e = bounds[d], bounds[d + 1]
        # histories: the globally sorted-per-user item arrays restricted
        # to this device's users (csr.keys is already sorted per segment)
        seg = csr.keys[csr.indptr[lo_u]:csr.indptr[hi_u]] if n_u > 0 \
            else np.zeros(0, dtype=csr.keys.dtype)
        hist_list.append(seg.astype(np.int32))
        indptr_list.append(indptr)
        counts_list.append(cnt)
        v = np.nonzero((cnt > 0) & (cnt < I))[0].astype(np.int32)
        valid_list.append(v)
        ev_u_list.append((users_s[lo_e:hi_e] - lo_u).astype(np.int32))
        ev_i_list.append(items_s[lo_e:hi_e].astype(np.int32))

    def stack_padded(arrs, pad_mode):
        L = max([1] + [a.size for a in arrs])
        out = np.zeros((n_devices, L), dtype=np.int32)
        for d, a in enumerate(arrs):
            if a.size == 0:
                continue
            if pad_mode == "cycle":
                reps = -(-L // a.size)
                out[d] = np.tile(a, reps)[:L]
            else:
                out[d, :a.size] = a
        return out

    max_count = int(counts_g.max()) if counts_g.size else 1
    depth = max(int(np.ceil(np.log2(max(max_count, 1) + 1))) + 1, 1)
    data = dict(
        hist_items=jnp.asarray(stack_padded(hist_list, "zero")),
        indptr=jnp.asarray(np.stack(indptr_list)),
        counts=jnp.asarray(np.stack(counts_list)),
        valid_users=jnp.asarray(stack_padded(valid_list, "cycle")),
        valid_count=jnp.asarray(
            np.array([v.size for v in valid_list], dtype=np.int32)),
        ev_user=jnp.asarray(stack_padded(ev_u_list, "cycle")),
        ev_item=jnp.asarray(stack_padded(ev_i_list, "cycle")),
        ev_count=jnp.asarray(
            np.array([a.size for a in ev_u_list], dtype=np.int32)),
    )
    meta = dict(num_items=I, num_users=U, u_loc=U_loc,
                e_loc=int(data["ev_user"].shape[1]),
                num_events=len(feedback), num_neg_trials=num_neg_trials,
                search_depth=depth)
    return data, meta




@functools.lru_cache(maxsize=32)
def _sharded_epoch_fn(mesh, batch_size: int, num_batches: int, regime: int,
                      meta_static, update_j: bool, soft_margin: bool):
    """Build + jit the sharded epoch once per (mesh, config); cached so
    repeated iterate() calls reuse the compiled executable."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    meta = dict(meta_static)
    trials, depth = meta["num_neg_trials"], meta["search_depth"]
    num_items = meta["num_items"]

    def device_fn(W, H, ib, hist, indptr, counts, valid, vcount,
                  ev_u, ev_i, ecount, key, pop_cdf, hps):
        hist, indptr, counts = hist[0], indptr[0], counts[0]
        valid, vcount = valid[0], vcount[0]
        ev_u, ev_i, ecount = ev_u[0], ev_i[0], ecount[0]
        lr, reg_u, reg_i, reg_j, bias_reg = hps
        H = jax.lax.pcast(H, "data", to="varying")
        ib = jax.lax.pcast(ib, "data", to="varying")
        d = jax.lax.axis_index("data")
        kd = jax.random.fold_in(key, d)
        sampler_loc = dict(hist_items=hist, indptr=indptr)

        if regime == UNIFORM_PAIR_WOR:
            n_pad = num_batches * batch_size
            perm = jax.random.permutation(
                jax.random.fold_in(kd, 0x5eed),
                jnp.arange(n_pad, dtype=jnp.int32))
        else:
            perm = None

        def batch_step(carry, b):
            W, H, ib = carry
            bkey = jax.random.fold_in(kd, b)
            k_u, k_i, k_j = jax.random.split(bkey, 3)
            if regime == UNIFORM_USER:
                uidx = jax.random.randint(k_u, (batch_size,), 0,
                                          valid.shape[0], dtype=jnp.int32)
                u = valid[uidx]
                r = jax.random.randint(k_i, (batch_size,), 0,
                                       jnp.iinfo(jnp.int32).max,
                                       dtype=jnp.int32)
                pos_off = r % jnp.maximum(counts[u], 1)
                i = hist[jnp.minimum(indptr[u] + pos_off,
                                     hist.shape[0] - 1)]
                base_w = ((counts[u] > 0) & (vcount > 0)).astype(jnp.float32)
            elif regime == UNIFORM_PAIR_WOR:
                eidx_raw = jax.lax.dynamic_slice(perm, (b * batch_size,),
                                                 (batch_size,))
                eidx = eidx_raw % jnp.maximum(ecount, 1)
                u = ev_u[eidx]
                i = ev_i[eidx]
                base_w = ((eidx_raw < ecount) & (ecount > 0)
                          ).astype(jnp.float32)
            else:  # UNIFORM_PAIR / WBPR: iid events
                eidx = jax.random.randint(k_u, (batch_size,), 0,
                                          ev_u.shape[0], dtype=jnp.int32)
                u = ev_u[eidx]
                i = ev_i[eidx]
                base_w = (ecount > 0).astype(jnp.float32)
            j, ok = _sample_negatives(
                k_j, sampler_loc, u, num_items, trials, depth,
                pop_cdf=pop_cdf if regime == WBPR else None)
            w = ok.astype(jnp.float32) * base_w

            wu = W[u]
            hi = H[i]
            hj = H[j]
            x_uij = ib[i] - ib[j] + jnp.sum(wu * (hi - hj), axis=-1)
            if soft_margin:
                g = jnp.where(x_uij < 1.0, 1.0, 0.0) * w
            else:
                g = jax.nn.sigmoid(-x_uij) * w
            W = W.at[u].add(
                lr * (g[:, None] * (hi - hj)
                      - (w * reg_u)[:, None] * wu))
            H_start, ib_start = H, ib
            H = H.at[i].add(
                lr * (g[:, None] * wu - (w * reg_i)[:, None] * hi))
            ib = ib.at[i].add(lr * (g - bias_reg * w * ib[i]))
            if update_j:
                H = H.at[j].add(
                    lr * (-g[:, None] * wu - (w * reg_j)[:, None] * hj))
                ib = ib.at[j].add(lr * (-g - bias_reg * w * ib[j]))
            # merge the devices' item updates (sub-epoch barrier)
            H = H_start + jax.lax.psum(H - H_start, "data")
            ib = ib_start + jax.lax.psum(ib - ib_start, "data")
            return (W, H, ib), None

        (W, H, ib), _ = jax.lax.scan(
            batch_step, (W, H, ib), jnp.arange(num_batches, dtype=jnp.int32))
        return W, H, ib

    # H/ib end replicated by construction (every device ends on
    # start + psum(deltas)); the varying-axis checker can't prove it.
    fn = shard_map(
        device_fn, mesh=mesh,
        in_specs=(P("data", None), P(), P(),
                  P("data", None), P("data", None), P("data", None),
                  P("data", None), P("data"), P("data", None),
                  P("data", None), P("data"), P(), P(), P()),
        out_specs=(P("data", None), P(), P()),
        check_vma=False)
    return jax.jit(fn)


def bpr_epoch_sharded(mesh, params, data, key, hp, pop_cdf, *,
                      batch_size: int, num_batches: int, regime: int,
                      meta_static, update_j: bool, soft_margin: bool = False):
    """One sharded epoch (reference MultiCoreBPRMF.cs:30 mapping).

    params: user_factors [n*U_loc, f] row-sharded over the 1-D 'data'
    mesh axis; item_factors [I, f] and item_bias [I] replicated. data
    from make_sampler_data_sharded, device axis sharded. Each device
    samples batch_size triples per step for its own users; item deltas
    are psum'd per step (sub-epoch minibatch barrier)."""
    fn = _sharded_epoch_fn(mesh, batch_size, num_batches, regime,
                           meta_static, update_j, soft_margin)
    hps = (hp["learn_rate"], hp["reg_u"], hp["reg_i"], hp["reg_j"],
           hp["bias_reg"])
    W, H, ib = fn(
        params["user_factors"], params["item_factors"], params["item_bias"],
        data["hist_items"], data["indptr"], data["counts"],
        data["valid_users"], data["valid_count"],
        data["ev_user"], data["ev_item"], data["ev_count"],
        key, pop_cdf if pop_cdf is not None else jnp.zeros(1), hps)
    return dict(user_factors=W, item_factors=H, item_bias=ib)
