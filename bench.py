"""Benchmark: BiasedMF SGD rating-update throughput on one GPU.

Headline metric matching BASELINE.md: the reference's BiasedMF on
Netflix k=40 runs ~242 s/iteration over ~100.5M ratings ~= 0.42M
sequential SGD rating-updates/s on CPU (reference doc/Performance:1-3).
Here: the blocked XLA epoch (ops/sgd.py sgd_epoch_blocked — user-slab
gathers, fused bias columns) on a Netflix-shaped synthetic dataset;
value = rating updates applied per second.

Refuses to run without a GPU. Prints the card's name and power limit on
stderr, then ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline", "device"}. Every timing ends in ``block_until_ready``.

BENCH_SUITE=1 additionally measures the other hot paths at the same
Netflix shape (stderr only; stdout stays the single headline line):
BPR triples/s, WRMF ALS, rating- and ranking-eval throughput, SVD++,
the KNN correlation build, LeastSquareSLIM and BiasedMF end to end.
"""

import json
import os
import sys
import time

import numpy as np

# Netflix-prize-shaped problem, scaled to keep bench wall-clock modest
NUM_USERS = int(os.environ.get("BENCH_USERS", 480_000))
NUM_ITEMS = int(os.environ.get("BENCH_ITEMS", 17_770))
NUM_RATINGS = int(os.environ.get("BENCH_RATINGS", 20_000_000))
NUM_FACTORS = int(os.environ.get("BENCH_FACTORS", 40))
BATCH = int(os.environ.get("BENCH_BATCH", 131_072))
GROUP = int(os.environ.get("BENCH_GROUP", 16_384))
EPOCHS = int(os.environ.get("BENCH_EPOCHS", 3))

BASELINE_UPDATES_PER_S = 0.42e6  # reference CPU, doc/Performance:1-3


def main():
    import jax
    import jax.numpy as jnp

    from mymedialite_tpu.ops import sgd
    from mymedialite_tpu.utils.compile_cache import enable_compile_cache
    from mymedialite_tpu.utils.device import describe_gpu, require_gpu

    enable_compile_cache()
    device = require_gpu()
    print(describe_gpu(), file=sys.stderr)

    rng = np.random.default_rng(0)
    users = rng.integers(0, NUM_USERS, NUM_RATINGS).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, NUM_RATINGS).astype(np.int32)
    values = rng.uniform(1.0, 5.0, NUM_RATINGS).astype(np.float32)

    data, meta = sgd.prepare_blocked_data(
        users, items, values, NUM_USERS, BATCH, GROUP, shuffle_seed=0)
    n_effective = meta["ngroups"] * meta["l_pad"]

    wu = 0.1 * rng.standard_normal((NUM_USERS, NUM_FACTORS)).astype(np.float32)
    hi = 0.1 * rng.standard_normal((NUM_ITEMS, NUM_FACTORS)).astype(np.float32)
    W_ext, H_ext = sgd.extend_tables(wu, hi, group_users=GROUP)

    hp = dict(global_bias=jnp.float32(0.0), min_rating=jnp.float32(1.0),
              rating_range=jnp.float32(4.0))
    rates = sgd.column_rates(NUM_FACTORS, 0.005, 0.015, 0.015, 1.0, 0.01,
                             True, True, True)
    freq = (jnp.zeros(0), jnp.zeros(0))
    key = jax.random.PRNGKey(0)

    def epoch(W, H, sub):
        return sgd.sgd_epoch_blocked(
            W, H, data, sub, hp, rates, freq,
            meta=tuple(sorted(meta.items())), loss=sgd.LOSS_RMSE,
            biased=True, frequency_regularization=False)

    key, sub = jax.random.split(key)
    t0 = time.time()
    W_ext, H_ext = jax.block_until_ready(epoch(W_ext, H_ext, sub))
    print(f"warmup+compile: {time.time() - t0:.1f}s  "
          f"({meta['ngroups']} groups x {meta['l_pad']} ratings, "
          f"batch {meta['batch']})", file=sys.stderr)

    t0 = time.time()
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        W_ext, H_ext = epoch(W_ext, H_ext, sub)
    jax.block_until_ready((W_ext, H_ext))
    elapsed = time.time() - t0
    print(f"checksum {float(jnp.sum(W_ext[:8])):.6f}", file=sys.stderr)

    updates_per_s = EPOCHS * n_effective / elapsed
    print(f"{EPOCHS} epochs in {elapsed:.2f}s -> "
          f"{updates_per_s/1e6:.2f}M updates/s (XLA blocked epoch)",
          file=sys.stderr)

    print(json.dumps({
        "metric": "biasedmf_sgd_rating_updates_per_s",
        "value": round(updates_per_s, 1),
        "unit": "updates/s",
        "vs_baseline": round(updates_per_s / BASELINE_UPDATES_PER_S, 2),
        "device": device,
    }))


# ---------------------------------------------------------------------------
# BENCH_SUITE: the other hot paths, stderr only
# ---------------------------------------------------------------------------

N_EVENTS = int(os.environ.get("BENCH_EVENTS", NUM_RATINGS))
BPR_BATCH = int(os.environ.get("BENCH_BPR_BATCH", 8192))   # model default
EVAL_USERS = int(os.environ.get("BENCH_EVAL_USERS", 4096))
PROBE = int(os.environ.get("BENCH_PROBE", 1_400_000))      # Netflix probe

# reference doc/Performance:3 — Netflix probe (~1.4M pairs) eval 0.45 s
BASELINE_EVAL_PRED_PER_S = 1_400_000 / 0.45


def _synth_feedback(rng):
    from mymedialite_tpu.data.arrays import PosOnlyData
    users = rng.integers(0, NUM_USERS, N_EVENTS).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, N_EVENTS).astype(np.int32)
    return PosOnlyData(users, items, num_users=NUM_USERS,
                       num_items=NUM_ITEMS)


def bench_bpr():
    """BPR triple-updates/s: one reference iteration = |events| triple
    updates (BPRMF.cs:152-160), on-device sampling + minibatch scatter."""
    import jax
    import jax.numpy as jnp

    from mymedialite_tpu.ops import bpr as bpr_ops

    rng = np.random.default_rng(1)
    fb = _synth_feedback(rng)
    sampler, meta = bpr_ops.make_sampler_data(fb)
    f = NUM_FACTORS
    params = dict(
        user_factors=jnp.asarray(
            0.1 * rng.standard_normal((NUM_USERS, f)).astype(np.float32)),
        item_factors=jnp.asarray(
            0.1 * rng.standard_normal((NUM_ITEMS, f)).astype(np.float32)),
        item_bias=jnp.zeros(NUM_ITEMS, dtype=jnp.float32))
    hp = {k: jnp.float32(v) for k, v in dict(
        learn_rate=0.05, reg_u=0.0025, reg_i=0.0025, reg_j=0.00025,
        bias_reg=0.0).items()}
    num_batches = max(len(fb) // BPR_BATCH, 1)
    key = jax.random.PRNGKey(0)

    def epoch(params, sub):
        return bpr_ops.bpr_epoch(
            params, sampler, sub, hp, None, batch_size=BPR_BATCH,
            num_batches=num_batches, regime=bpr_ops.UNIFORM_USER,
            meta_static=tuple(sorted(meta.items())), update_j=True)

    key, sub = jax.random.split(key)
    params = jax.block_until_ready(epoch(params, sub))
    t0 = time.time()
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        params = epoch(params, sub)
    jax.block_until_ready(params)
    elapsed = time.time() - t0
    triples_per_s = EPOCHS * num_batches * BPR_BATCH / elapsed
    print(f"SUITE bpr_triple_updates_per_s {triples_per_s/1e6:.2f}M "
          f"(XLA minibatch epoch; {EPOCHS} epochs x "
          f"{num_batches * BPR_BATCH} triples in {elapsed:.2f}s)",
          file=sys.stderr)
    return triples_per_s


def bench_wrmf():
    """WRMF ALS ratings/s-equivalent: one full alternation (user + item
    solves) over nnz events (reference WRMF.cs:68-156)."""
    import jax

    from mymedialite_tpu.models.wrmf import WRMF

    rng = np.random.default_rng(2)
    fb = _synth_feedback(rng)
    m = WRMF()
    m.num_factors = NUM_FACTORS
    m.num_iter = 1
    m.feedback = fb
    m.train()  # includes prep + compile
    t0 = time.time()
    m.iterate()
    jax.block_until_ready(m.params)
    elapsed = time.time() - t0
    ratings_per_s = len(fb) / elapsed
    print(f"SUITE wrmf_als_ratings_per_s {ratings_per_s/1e6:.2f}M "
          f"(1 alternation over {len(fb)} events in {elapsed:.2f}s)",
          file=sys.stderr)
    return ratings_per_s


def bench_eval():
    """Rating-eval predictions/s on a Netflix-sized probe (reference
    0.45 s / 1.4M pairs, doc/Performance:3) and ranking-eval users/s
    (full-catalog fused score+rank top-10)."""
    from mymedialite_tpu.data.arrays import PosOnlyData, RatingData
    from mymedialite_tpu.eval.ranking import evaluate_items
    from mymedialite_tpu.eval.rating import evaluate_ratings
    from mymedialite_tpu.models.mf import BiasedMatrixFactorization

    rng = np.random.default_rng(3)
    # small training set: eval speed is independent of training length
    n_train = min(N_EVENTS, 2_000_000)
    train = RatingData(
        rng.integers(0, NUM_USERS, n_train).astype(np.int32),
        rng.integers(0, NUM_ITEMS, n_train).astype(np.int32),
        rng.uniform(1, 5, n_train).astype(np.float32),
        num_users=NUM_USERS, num_items=NUM_ITEMS)
    m = BiasedMatrixFactorization()
    m.num_factors = NUM_FACTORS
    m.num_iter = 1
    m.ratings = train
    m.train()

    probe = RatingData(
        rng.integers(0, NUM_USERS, PROBE).astype(np.int32),
        rng.integers(0, NUM_ITEMS, PROBE).astype(np.int32),
        rng.uniform(1, 5, PROBE).astype(np.float32),
        num_users=NUM_USERS, num_items=NUM_ITEMS)
    evaluate_ratings(m, probe)  # warm
    t0 = time.time()
    evaluate_ratings(m, probe)
    elapsed = time.time() - t0
    pred_per_s = PROBE / elapsed
    print(f"SUITE rating_eval_predictions_per_s {pred_per_s/1e6:.2f}M "
          f"({PROBE} pairs in {elapsed:.2f}s, "
          f"vs_baseline {pred_per_s / BASELINE_EVAL_PRED_PER_S:.1f}x)",
          file=sys.stderr)

    # test items from the top id range, train restricted below it, so the
    # per-user ignore sets never swallow relevant items (AUC.cs:64 guard)
    split_at = NUM_ITEMS - max(NUM_ITEMS // 16, 4)
    test_u = rng.choice(NUM_USERS, EVAL_USERS, replace=False).astype(np.int32)
    test = PosOnlyData(np.repeat(test_u, 3),
                       rng.integers(split_at, NUM_ITEMS, 3 * EVAL_USERS)
                       .astype(np.int32),
                       num_users=NUM_USERS, num_items=NUM_ITEMS)
    ptrain = PosOnlyData(train.users, train.items % split_at,
                         num_users=NUM_USERS, num_items=NUM_ITEMS)
    kw = dict(candidate_item_mode="UNION")
    # warm with the full user set: a subset's bucketed ignore/correct
    # widths can differ and the measured run would recompile
    evaluate_items(m, test, ptrain, test_users=test_u, **kw)  # warm
    t0 = time.time()
    evaluate_items(m, test, ptrain, test_users=test_u, **kw)
    elapsed = time.time() - t0
    users_per_s = EVAL_USERS / elapsed
    print(f"SUITE ranking_eval_users_per_s {users_per_s:.0f} "
          f"({EVAL_USERS} users x {NUM_ITEMS}-item catalog "
          f"in {elapsed:.2f}s)", file=sys.stderr)
    return pred_per_s, users_per_s


def bench_svdpp():
    """SVD++ rating-updates/s at the Netflix shape through the model's
    own iterate (reference SVDPlusPlus.cs:157-213 — the per-update scan
    over the user's whole item history is the reference's heaviest
    rating-side loop; here it is the grouped segment-sum epoch,
    ops/svdpp.py)."""
    import jax.numpy as jnp

    from mymedialite_tpu.data.arrays import RatingData
    from mymedialite_tpu.models.svdpp import SVDPlusPlus

    rng = np.random.default_rng(7)
    users = rng.integers(0, NUM_USERS, NUM_RATINGS).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, NUM_RATINGS).astype(np.int32)
    values = rng.uniform(1.0, 5.0, NUM_RATINGS).astype(np.float32)
    m = SVDPlusPlus()
    m.num_factors = 20          # reference-typical k for SVD++
    m.num_iter = 1
    m.ratings = RatingData(users, items, values, num_users=NUM_USERS,
                           num_items=NUM_ITEMS)
    t0 = time.time()
    m.train()                   # prep + compile + 1 epoch
    assert np.isfinite(m.predict_batch(users[:8], items[:8])).all()
    print(f"svdpp prep+compile+1ep: {time.time() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    for _ in range(EPOCHS):
        m.iterate()
    sync = m.predict_batch(users[:8], items[:8])
    assert np.isfinite(sync).all()
    upd_per_s = EPOCHS * NUM_RATINGS / (time.time() - t0)
    print(f"SUITE svdpp_rating_updates_per_s {upd_per_s/1e6:.2f}M "
          f"({EPOCHS} epochs x {NUM_RATINGS} in "
          f"{EPOCHS * NUM_RATINGS / upd_per_s:.2f}s, "
          f"vs_baseline {upd_per_s / BASELINE_UPDATES_PER_S:.0f}x)",
          file=sys.stderr)
    return upd_per_s


def bench_knn_corr():
    """UserKNN correlation-matrix build at 480k entities — the
    reference's KNN cost center (Overlap.cs:26: O(sum count_i^2)
    co-occurrence counting). Here: the streaming tiled Gram
    top-k (ops/correlation.py binary_correlation_topk)."""
    from mymedialite_tpu.data.arrays import PosOnlyData
    from mymedialite_tpu.ops import correlation as corr_ops

    rng = np.random.default_rng(8)
    fb = _synth_feedback(rng)
    # first call compiles (the incidence is ~n*m bytes of HBM — one at
    # a time; a slice-shaped warm-up would allocate a SECOND full-size
    # incidence and OOM)
    t0 = time.time()
    corr_ops.binary_correlation_topk(fb, NUM_USERS, NUM_ITEMS, k=80,
                                     kind="cosine")
    print(f"knn corr compile+run: {time.time() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    ids, vals = corr_ops.binary_correlation_topk(
        fb, NUM_USERS, NUM_ITEMS, k=80, kind="cosine")
    elapsed = time.time() - t0
    assert np.isfinite(vals).all()
    # reference cost model: sum over items of count_i^2 hash-set
    # increments (Overlap.cs:26-56)
    counts = np.bincount(fb.items, minlength=NUM_ITEMS).astype(np.float64)
    ref_pairs = float((counts ** 2).sum())
    print(f"SUITE knn_corr_build_seconds {elapsed:.2f} "
          f"({NUM_USERS} users x {NUM_ITEMS} items x {len(fb)} events, "
          f"k=80 cosine; reference Overlap does {ref_pairs:.3g} "
          f"pair-increments)", file=sys.stderr)
    return elapsed


def bench_slim():
    """LeastSquareSLIM coordinate-descent items/s (reference
    LeastSquareSLIM.cs:88-128: Parallel.For over items, elastic-net
    coordinate descent restricted to item-kNN neighborhoods)."""
    import jax

    from mymedialite_tpu.data.arrays import PosOnlyData
    from mymedialite_tpu.models.slim import LeastSquareSLIM

    rng = np.random.default_rng(9)
    n = min(N_EVENTS, 4_000_000)   # SLIM catalogs are item-bound
    fb = PosOnlyData(
        rng.integers(0, NUM_USERS, n).astype(np.int32),
        rng.integers(0, NUM_ITEMS, n).astype(np.int32),
        num_users=NUM_USERS, num_items=NUM_ITEMS)
    m = LeastSquareSLIM()
    m.num_iter = 1
    m.feedback = fb
    t0 = time.time()
    m.train()                      # kNN select + compile + 1 iteration
    jax.block_until_ready(m.W)
    print(f"slim prep+compile+1it: {time.time() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    m.iterate()
    jax.block_until_ready(m.W)
    elapsed = time.time() - t0
    assert np.isfinite(np.asarray(
        m.predict_batch(fb.users[:8], fb.items[:8]))).all()
    items_per_s = NUM_ITEMS / elapsed
    print(f"SUITE slim_cd_items_per_s {items_per_s:.0f} "
          f"(1 coordinate-descent sweep over {NUM_ITEMS} items "
          f"in {elapsed:.2f}s)", file=sys.stderr)
    return items_per_s


def bench_eval_device():
    """Rating-eval device time: K back-to-back metric dispatches of the
    fused predict+reduce kernel on one probe, timed around
    ``block_until_ready``, isolating the kernel from host prep."""
    import jax
    import jax.numpy as jnp

    from mymedialite_tpu.data.arrays import RatingData
    from mymedialite_tpu.eval import rating as rating_eval
    from mymedialite_tpu.models.mf import BiasedMatrixFactorization

    rng = np.random.default_rng(10)
    n_train = min(N_EVENTS, 2_000_000)
    train = RatingData(
        rng.integers(0, NUM_USERS, n_train).astype(np.int32),
        rng.integers(0, NUM_ITEMS, n_train).astype(np.int32),
        rng.uniform(1, 5, n_train).astype(np.float32),
        num_users=NUM_USERS, num_items=NUM_ITEMS)
    m = BiasedMatrixFactorization()
    m.num_factors = NUM_FACTORS
    m.num_iter = 1
    m.ratings = train
    m.train()
    probe = RatingData(
        rng.integers(0, NUM_USERS, PROBE).astype(np.int32),
        rng.integers(0, NUM_ITEMS, PROBE).astype(np.int32),
        rng.uniform(1, 5, PROBE).astype(np.float32),
        num_users=NUM_USERS, num_items=NUM_ITEMS)
    fn, params = m.pair_scorer()
    if getattr(fn, "WANTS_UGATHER", False):
        # banked windowed user gather (ops/gather.py) — the production
        # selection at this shape since r5
        u, i, v, w, bases = rating_eval._device_eval_arrays_banked(probe)
        params = dict(params, _ugather_bases=bases)
    else:
        u, i, v, w = rating_eval._device_eval_arrays(probe)
    jfn = rating_eval._metrics_jit(fn, False)
    lo, hi = jnp.float32(1.0), jnp.float32(5.0)
    cu = ci = jnp.zeros(1, jnp.int32)
    args = (params, u, i, v, w, lo, hi, cu, ci,
            jnp.int32(0), jnp.int32(0))
    jax.block_until_ready(jfn(*args))  # warm
    K = 20
    t0 = time.time()
    jax.block_until_ready([jfn(*args) for _ in range(K)])
    per_eval = (time.time() - t0) / K
    pred_per_s = PROBE / per_eval
    print(f"SUITE rating_eval_device_predictions_per_s "
          f"{pred_per_s/1e6:.1f}M ({PROBE} pairs in {per_eval*1000:.1f}ms "
          f"per dispatch over {K}; vs_baseline "
          f"{pred_per_s / BASELINE_EVAL_PRED_PER_S:.0f}x)",
          file=sys.stderr)
    return pred_per_s


def bench_rank_tiled():
    """Ranking-eval users/s at the big (KDD-Cup 624,961-item) catalog —
    the r3 record covered 17,770 items only."""
    from mymedialite_tpu.data.arrays import PosOnlyData
    from mymedialite_tpu.eval.ranking import evaluate_items
    from mymedialite_tpu.models.bpr import BPRMF

    U = int(os.environ.get("BENCH_BIGCAT_USERS", 62_561))
    I = int(os.environ.get("BENCH_BIGCAT_ITEMS", 624_961))
    n_users = int(os.environ.get("BENCH_RANK_USERS", 1024))
    rng = np.random.default_rng(11)
    n = min(2_000_000, U * 40)
    split_at = I - max(I // 16, 4)
    train = PosOnlyData(
        rng.integers(0, U, n).astype(np.int32),
        rng.integers(0, split_at, n).astype(np.int32),
        num_users=U, num_items=I)
    m = BPRMF()
    m.num_factors = NUM_FACTORS
    m.num_iter = 0
    m.feedback = train
    m.init_model()
    test_u = rng.choice(U, n_users, replace=False).astype(np.int32)
    test = PosOnlyData(
        np.repeat(test_u, 3),
        rng.integers(split_at, I, 3 * n_users).astype(np.int32),
        num_users=U, num_items=I)
    kw = dict(candidate_item_mode="UNION")
    evaluate_items(m, test, train, test_users=test_u, **kw)  # warm
    t0 = time.time()
    evaluate_items(m, test, train, test_users=test_u, **kw)
    elapsed = time.time() - t0
    users_per_s = n_users / elapsed
    print(f"SUITE ranking_eval_users_per_s_bigcat {users_per_s:.0f} "
          f"({n_users} users x {I}-item catalog in {elapsed:.2f}s)",
          file=sys.stderr)
    return users_per_s


def bench_end_to_end():
    """End-to-end time-to-train: BiasedMF k=40, num_iter=30 at the
    Netflix shape through model.train()'s pieces — epoch-data prep +
    compile + 30 epochs — plus the device-resident 1.4M-pair eval, vs the
    reference protocol's 30 x 241.57 s training + 0.45 s eval
    (doc/Performance:1-6). Reports the phase split."""
    import jax

    from mymedialite_tpu.data.arrays import RatingData
    from mymedialite_tpu.eval.rating import evaluate_ratings
    from mymedialite_tpu.models.mf import BiasedMatrixFactorization

    rng = np.random.default_rng(12)
    users = rng.integers(0, NUM_USERS, NUM_RATINGS).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, NUM_RATINGS).astype(np.int32)
    values = rng.uniform(1.0, 5.0, NUM_RATINGS).astype(np.float32)
    probe_n = 1_408_395                  # the Netflix probe size
    probe = RatingData(
        rng.integers(0, NUM_USERS, probe_n).astype(np.int32),
        rng.integers(0, NUM_ITEMS, probe_n).astype(np.int32),
        rng.uniform(1, 5, probe_n).astype(np.float32),
        num_users=NUM_USERS, num_items=NUM_ITEMS)

    m = BiasedMatrixFactorization()
    m.num_factors = NUM_FACTORS
    m.num_iter = 30
    m.ratings = RatingData(users, items, values, num_users=NUM_USERS,
                           num_items=NUM_ITEMS)
    t0 = time.time()
    m.init_model()
    jax.block_until_ready((m.W_ext, m.H_ext, m._blocked))
    t_prep = time.time() - t0
    t0 = time.time()
    m.iterate()
    jax.block_until_ready((m.W_ext, m.H_ext))
    t_compile = time.time() - t0
    t0 = time.time()
    for _ in range(m.num_iter - 1):
        m.iterate()
    jax.block_until_ready((m.W_ext, m.H_ext))
    t_epochs = time.time() - t0
    t0 = time.time()
    res = evaluate_ratings(m, probe)
    t_eval = time.time() - t0
    total = t_prep + t_compile + t_epochs + t_eval
    ref_total = 30 * 241.57 + 0.45
    print(f"SUITE end_to_end_seconds {total:.1f} "
          f"(prep+upload {t_prep:.1f} + compile+1ep {t_compile:.1f} + 29ep "
          f"{t_epochs:.1f} + eval {t_eval:.1f}; RMSE {res['RMSE']:.4f}; "
          f"vs reference 30x241.57s+0.45s = {ref_total:.0f}s -> "
          f"{ref_total / total:.0f}x)", file=sys.stderr)
    return total


if __name__ == "__main__":
    main()
    if os.environ.get("BENCH_SUITE"):
        bench_bpr()
        bench_wrmf()
        bench_eval()
        bench_eval_device()
        bench_rank_tiled()
        bench_svdpp()
        bench_knn_corr()
        bench_slim()
        bench_end_to_end()
