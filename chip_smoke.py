"""GPU smoke run of the main paths at Netflix widths, in one process.

    python chip_smoke.py                       # one card, 20M ratings
    python chip_smoke.py --ratings 100480507   # the full Netflix scale
    python chip_smoke.py --four                # the 4-card paths only

The data is a seeded Netflix-shaped set (480,189 users x 17,770 items,
Zipf item popularity, log-normal user activity) with a disjoint
1,408,395-pair probe. One-card phases, in order:

1. rating: BiasedMatrixFactorization (k=40) from the registry, 3 epochs
   through ``train()``; probe RMSE must beat GlobalAverage.
2. item: positives are ratings >= 4. BPRMF (k=40, 2 epochs) and WRMF
   (k=40, 1 alternation); AUC over the full catalog for 4,096 test users
   must beat MostPopular.
3. svdpp: one SVDPlusPlus epoch (k=20) on a 5M-rating subset.
4. cli: the rating and item CLIs, called in-process on a seeded
   ~1M-rating file pair; their result lines must parse.
5. check: each phase's epoch or evaluation run once on the CPU (at
   ``highest`` matmul precision) and once on the GPU, on a subsample at
   full table widths, compared within the tolerances below.

``--four`` runs only the paths that engage with more than one device
(MultiCoreBPRMF, sharded WRMF, sharded SVD++, data-parallel ranking
eval), each against the same model restricted to the first card.

Every phase prints its compile seconds, iteration seconds (each ended by
``block_until_ready``) and peak device memory beside the card's name and
power limit. The last line is ``{"ok": true, "device": {...}}``; a
failed phase exits non-zero without it, and so does a run that finds no
GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

import jax

from mymedialite_tpu.data.arrays import PosOnlyData
from mymedialite_tpu.data.synthetic import (
    synthetic_ratings_at_scale, write_rating_files,
)
from mymedialite_tpu.eval import ranking
from mymedialite_tpu.eval.ranking import evaluate_items
from mymedialite_tpu.eval.rating import evaluate_ratings
from mymedialite_tpu.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from mymedialite_tpu.ops import als as als_ops
from mymedialite_tpu.ops import bpr as bpr_ops
from mymedialite_tpu.ops import svdpp as svdpp_ops
from mymedialite_tpu.utils.compile_cache import enable_compile_cache
from mymedialite_tpu.utils.device import describe_gpu, require_gpu

# --- tolerances of the CPU-vs-GPU comparison --------------------------
# Each is set about 20x above the largest difference read on an H100.
# Epoch tables: GPU scatter-adds are atomics whose order changes from run
# to run, and the two backends round transcendental functions
# differently, so tables agree to float32 rounding accumulated over one
# epoch (read: <= 4.8e-7): |gpu - cpu| <= TABLE_RTOL * max(1, max|cpu|).
# A TF32 product in an epoch (relative rounding ~5e-4) exceeds it.
TABLE_RTOL = 1e-5
# Rating metrics: the same predictions summed in another order (read:
# <= 1.6e-8 relative).
RATING_RTOL = 1e-6
# Ranking metrics: GPU catalog scoring runs at the default matmul
# precision (TF32), which reorders near-tied items (read: <= 0.00098, one
# item of one of 512 users). Each metric averages over the users, so one
# changed top-10 list moves a metric by up to 1/512.
RANK_ATOL = 0.005
# --four: BPR and SVD++ on 4 cards run another (sharded) update
# schedule than on one card, so their quality agrees within a band.
# WRMF row solves and ranking are per-row computations and must be
# identical.
FOUR_AUC_BAND = 0.03
FOUR_RMSE_BAND = 0.02
# Two BPR epochs at the reference's default step (0.05) leave the
# factors near their random start; a larger step learns the taste
# structure within the two epochs.
BPR_LEARN_RATE = 0.2


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Data and model sizes; the defaults are the Netflix widths."""
    num_users: int = 480_189
    num_items: int = 17_770
    num_ratings: int = 20_000_000
    num_probe: int = 1_408_395
    num_factors: int = 40
    rating_epochs: int = 3
    bpr_epochs: int = 2
    bpr_batch: int = 8192        # the BPRMF default
    eval_users: int = 4096
    svdpp_ratings: int = 5_000_000
    svdpp_factors: int = 20
    cli_users: int = 6040
    cli_items: int = 3706
    cli_ratings: int = 1_000_000
    check_events: int = 1_000_000
    check_als_rows: int = 4096
    check_rank_users: int = 512
    num_tastes: int = 64         # taste groups of ~280 items each
    seed: int = 42


class Report:
    """Per-phase timing lines: compile seconds (JAX's own compile
    events), iteration seconds and peak device memory."""

    def __init__(self, card: str):
        self.card = card
        self._compile = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event.startswith("/jax/core/compile/") or \
                event == "/jax/compilation_cache/cache_retrieval_time_sec":
            self._compile += duration

    def start(self):
        self._compile = 0.0
        self._t0 = time.perf_counter()

    def line(self, phase: str, **fields):
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", "not measured")
        parts = [f"phase={phase}",
                 f"wall_s={time.perf_counter() - self._t0:.3f}",
                 f"compile_s={self._compile:.3f}"]
        for k, v in fields.items():
            if isinstance(v, (list, tuple)):
                v = "[" + ",".join(f"{x:.4f}" for x in v) + "]"
            elif isinstance(v, float):
                v = f"{v:.6g}"
            parts.append(f"{k}={v}")
        parts += [f"peak_bytes={peak}", f"card=\"{self.card}\""]
        print("timing " + " ".join(parts), flush=True)


def time_iterations(model, tables):
    """Make ``model.train()`` record each ``iterate()``'s seconds, ended
    by ``block_until_ready`` on ``tables(model)``."""
    times = []
    inner = model.iterate

    def iterate(*a, **k):
        t = time.perf_counter()
        out = inner(*a, **k)
        jax.block_until_ready(tables(model))
        times.append(time.perf_counter() - t)
        return out

    model.iterate = iterate
    return times


def _mf_tables(m):
    return m.W_ext, m.H_ext


def _params(m):
    return m.params


def make_data(sizes: Sizes):
    return synthetic_ratings_at_scale(
        sizes.num_users, sizes.num_items, sizes.num_ratings,
        sizes.num_probe, num_tastes=sizes.num_tastes, seed=sizes.seed)


def positives(data):
    keep = data.values >= 4.0
    return PosOnlyData(data.users[keep], data.items[keep],
                       num_users=data.num_users, num_items=data.num_items)


def pick_test_users(train_pos, test_pos, n: int, seed: int):
    """Up to n users with positives on both sides, drawn with a seed."""
    both = np.intersect1d(np.unique(train_pos.users),
                          np.unique(test_pos.users))
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(both, min(n, both.size), replace=False))


def rank_eval(model, train_pos, test_pos, users):
    return evaluate_items(model, test_pos, train_pos, test_users=users,
                          candidate_items=np.arange(train_pos.num_items),
                          candidate_item_mode="EXPLICIT")


# --- phases -------------------------------------------------------------

def rating_phase(train, probe, sizes: Sizes, report: Report):
    report.start()
    m = create_rating_predictor("BiasedMatrixFactorization")
    m.num_factors = sizes.num_factors
    m.num_iter = sizes.rating_epochs
    m.ratings = train
    times = time_iterations(m, _mf_tables)
    m.train()
    t = time.perf_counter()
    res = evaluate_ratings(m, probe)
    t_eval = time.perf_counter() - t
    ga = create_rating_predictor("GlobalAverage")
    ga.ratings = train
    ga.train()
    ga_rmse = evaluate_ratings(ga, probe)["RMSE"]
    report.line("rating", epoch_s=times, eval_s=t_eval, rmse=res["RMSE"],
                global_average_rmse=ga_rmse)
    if not np.isfinite(res["RMSE"]) or res["RMSE"] >= ga_rmse:
        raise AssertionError(f"BiasedMF probe RMSE {res['RMSE']} does not "
                             f"beat GlobalAverage {ga_rmse}")
    return m


def item_phase(train, probe, sizes: Sizes, report: Report):
    report.start()
    train_pos, test_pos = positives(train), positives(probe)
    users = pick_test_users(train_pos, test_pos, sizes.eval_users,
                            sizes.seed)
    mp = create_item_recommender("MostPopular")
    mp.feedback = train_pos
    mp.train()
    mp_auc = rank_eval(mp, train_pos, test_pos, users)["AUC"]
    models = {}
    for name, iters in (("BPRMF", sizes.bpr_epochs), ("WRMF", 1)):
        m = create_item_recommender(name)
        m.num_factors = sizes.num_factors
        m.num_iter = iters
        if name == "BPRMF":
            m.learn_rate = BPR_LEARN_RATE
            m.batch_size = sizes.bpr_batch
        m.feedback = train_pos
        times = time_iterations(m, _params)
        m.train()
        t = time.perf_counter()
        res = rank_eval(m, train_pos, test_pos, users)
        t_eval = time.perf_counter() - t
        if name == "WRMF":
            # the first alternation holds the compiles; time one more
            m.iterate()
        report.line(f"item-{name}", epoch_s=times, eval_s=t_eval,
                    auc=res["AUC"], most_popular_auc=mp_auc,
                    eval_users=len(users))
        if not res["AUC"] > mp_auc:
            raise AssertionError(f"{name} AUC {res['AUC']} does not beat "
                                 f"MostPopular {mp_auc}")
        models[name] = m
        report.start()
    return models, (train_pos, test_pos, users)


def svdpp_subset(train, n: int, seed: int):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(len(train), min(n, len(train)), replace=False))
    return train.select(idx)


def svdpp_phase(train, probe, sizes: Sizes, report: Report):
    report.start()
    m = create_rating_predictor("SVDPlusPlus")
    m.num_factors = sizes.svdpp_factors
    m.num_iter = 1
    m.ratings = svdpp_subset(train, sizes.svdpp_ratings, sizes.seed)
    times = time_iterations(m, _params)
    m.train()
    res = evaluate_ratings(m, probe)
    report.line("svdpp", epoch_s=times, ratings=len(m.ratings),
                rmse=res["RMSE"])
    if not np.isfinite(res["RMSE"]):
        raise AssertionError(f"SVD++ probe RMSE {res['RMSE']}")
    return m


RATING_LINE = re.compile(r"RMSE \d[\d.]* MAE \d[\d.]* CBD \d[\d.]*")
ITEM_LINE = re.compile(r"AUC \d[\d.]* prec@5 \d[\d.]* num_items \d+ "
                       r"num_lists \d+")


def cli_phase(sizes: Sizes, report: Report):
    from mymedialite_tpu.cli import item_recommendation, rating_prediction
    report.start()
    with tempfile.TemporaryDirectory() as d:
        tr, te = os.path.join(d, "train.tsv"), os.path.join(d, "test.tsv")
        write_rating_files(tr, te, num_users=sizes.cli_users,
                           num_items=sizes.cli_items,
                           num_ratings=sizes.cli_ratings,
                           num_test=sizes.cli_ratings // 10, seed=sizes.seed)
        runs = (
            (rating_prediction, RATING_LINE, "BiasedMatrixFactorization",
             f"num_factors={sizes.num_factors} num_iter=2"),
            (item_recommendation, ITEM_LINE, "BPRMF",
             f"num_factors={sizes.num_factors} num_iter=2"),
        )
        for cli, pattern, rec, opts in runs:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["--training-file", tr, "--test-file", te,
                               "--recommender", rec,
                               "--recommender-options", opts,
                               "--random-seed", str(sizes.seed)])
            text = out.getvalue()
            match = pattern.search(text)
            if rc != 0 or match is None:
                raise AssertionError(f"{cli.__name__} rc={rc}, no result "
                                     f"line in:\n{text}")
            print(f"cli {cli.__name__.rsplit('.', 1)[-1]}: {match.group(0)}",
                  flush=True)
    report.line("cli")


@contextlib.contextmanager
def on_device(device, reference: bool):
    """Run JAX work on ``device``; the reference side at ``highest``
    matmul precision."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax.default_device(device))
        if reference:
            stack.enter_context(jax.default_matmul_precision("highest"))
        yield


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _table_diff(a, b):
    """Largest |a - b| over matching arrays, relative to max(1, max|b|)."""
    worst = 0.0
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x.shape != y.shape:
            raise AssertionError(f"shape {x.shape} vs {y.shape}")
        scale = max(1.0, float(np.abs(y).max(initial=0.0)))
        worst = max(worst, float(np.abs(x - y).max(initial=0.0)) / scale)
    return worst


def _train_tables(create, name, data, num_factors, data_attr):
    m = create(name)
    m.num_factors = num_factors
    m.num_iter = 1
    setattr(m, data_attr, data)
    m.train()
    return _host(_mf_tables(m) if hasattr(m, "W_ext") else m.params)


def check_phase(train, probe, rating_model, bpr_model, eval_data,
                sizes: Sizes, report: Report):
    """The CPU (highest precision) against the default device (the GPU),
    each check at full table widths."""
    report.start()
    cpu = jax.devices("cpu")[0]
    device = jax.devices()[0]
    rng = np.random.default_rng(sizes.seed + 1)
    sub = train.select(np.sort(rng.choice(
        len(train), min(sizes.check_events, len(train)), replace=False)))
    sub_pos = positives(sub)
    als_rows = sub_pos.users < sizes.check_als_rows
    als_fb = PosOnlyData(sub_pos.users[als_rows], sub_pos.items[als_rows],
                         num_users=sizes.check_als_rows,
                         num_items=sizes.num_items)
    epoch_checks = (
        ("sgd", create_rating_predictor, "BiasedMatrixFactorization", sub,
         sizes.num_factors, "ratings"),
        ("bpr", create_item_recommender, "BPRMF", sub_pos,
         sizes.num_factors, "feedback"),
        ("als", create_item_recommender, "WRMF", als_fb,
         sizes.num_factors, "feedback"),
        ("svdpp", create_rating_predictor, "SVDPlusPlus", sub,
         sizes.svdpp_factors, "ratings"),
    )
    failures = []
    for check, create, name, data, f, attr in epoch_checks:
        with on_device(cpu, reference=True):
            ref = _train_tables(create, name, data, f, attr)
        with on_device(device, reference=False):
            got = _train_tables(create, name, data, f, attr)
        diff = _table_diff(got, ref)
        ok = diff <= TABLE_RTOL
        print(f"check {check} ({name}, {len(data)} events): max rel table "
              f"diff {diff:.3e} <= {TABLE_RTOL:g}: {ok}", flush=True)
        if not ok:
            failures.append(check)

    # rating evaluation of the trained BiasedMF
    got = evaluate_ratings(rating_model, probe)
    cpu_model = copy.copy(rating_model)
    cpu_model.W_ext, cpu_model.H_ext = _host(_mf_tables(rating_model))
    with on_device(cpu, reference=True):
        # a fresh copy: the evaluator caches the test set on the device
        ref = evaluate_ratings(cpu_model, probe.select(np.arange(len(probe))))
    for key in ("RMSE", "MAE"):
        diff = abs(got[key] - ref[key]) / max(abs(ref[key]), 1e-12)
        ok = diff <= RATING_RTOL
        print(f"check rating-eval {key}: gpu {got[key]:.6f} cpu "
              f"{ref[key]:.6f} rel diff {diff:.3e} <= {RATING_RTOL:g}: "
              f"{ok}", flush=True)
        if not ok:
            failures.append(f"rating-eval {key}")

    # ranking evaluation of the trained BPRMF
    train_pos, test_pos, users = eval_data
    users = users[:sizes.check_rank_users]
    got = rank_eval(bpr_model, train_pos, test_pos, users)
    cpu_model = copy.copy(bpr_model)
    cpu_model.params = _host(bpr_model.params)
    with on_device(cpu, reference=True):
        ref = rank_eval(cpu_model, train_pos, test_pos, users)
    for key in ref.ALL_MEASURES:
        ok = abs(got[key] - ref[key]) <= RANK_ATOL
        print(f"check ranking {key}: gpu {got[key]:.5f} cpu {ref[key]:.5f} "
              f"(|diff| <= {RANK_ATOL:g}): {ok}", flush=True)
        if not ok:
            failures.append(f"ranking {key}")
    report.line("check", events=len(sub), rank_users=len(users))
    if failures:
        raise AssertionError(f"CPU-vs-GPU checks failed: {failures}")


# --- four cards ---------------------------------------------------------

@contextlib.contextmanager
def first_card_only():
    """The package decides every mesh from ``jax.devices()``; narrowing
    that list to the first card runs a model as it runs on a one-card
    host, inside this process."""
    real = jax.devices

    def devices(backend=None):
        return real(backend)[:1] if backend is None else real(backend)

    jax.devices = devices
    try:
        with jax.default_device(real()[0]):
            yield
    finally:
        jax.devices = real


@contextlib.contextmanager
def outputs_of(module, name: str):
    """Collect the arrays that ``module.<name>`` returns while the block
    runs (the models call the sharded ops through their module)."""
    real = getattr(module, name)
    seen = []

    def spy(*a, **k):
        out = real(*a, **k)
        seen.extend(jax.tree.leaves(out))
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _spans(arrays, n: int) -> bool:
    """Every array is laid out over n devices (and there is one)."""
    return bool(arrays) and all(len(a.sharding.device_set) == n
                                for a in arrays)


def four_phase(train, probe, sizes: Sizes, report: Report, n: int = 4):
    """The multi-device paths on ``n`` devices against one device."""
    if len(jax.devices()) != n:
        raise AssertionError(f"--four needs {n} devices, "
                             f"found {len(jax.devices())}")
    train_pos, test_pos = positives(train), positives(probe)
    users = pick_test_users(train_pos, test_pos, sizes.eval_users,
                            sizes.seed)
    failures = []

    def item_model(name, iters):
        m = create_item_recommender(name)
        m.num_factors = sizes.num_factors
        m.num_iter = iters
        if "BPR" in name:
            m.learn_rate = BPR_LEARN_RATE
            m.batch_size = sizes.bpr_batch
        m.feedback = train_pos
        times = time_iterations(m, _params)
        m.train()
        return m, times

    # WRMF: sharded row solves must equal the one-card solves bit for bit
    report.start()
    with outputs_of(als_ops, "wrmf_optimize_sharded") as out:
        wrmf4, times4 = item_model("WRMF", 1)
    if not _spans(out, n):
        failures.append(f"WRMF solves do not span {n} devices")
    with first_card_only():
        wrmf1, times1 = item_model("WRMF", 1)
    same = all(np.array_equal(np.asarray(wrmf4.params[k]),
                              np.asarray(wrmf1.params[k]))
               for k in ("user_factors", "item_factors"))
    print(f"four WRMF: {n}-card factors bit-identical to 1-card: {same}",
          flush=True)
    if not same:
        failures.append("WRMF not bit-identical")
    report.line("four-wrmf", alternation_s_4=times4, alternation_s_1=times1)

    # data-parallel ranking eval of one model: identical metrics
    report.start()
    real_kernel = ranking._rank_kernel

    def rank_kernel(*a):
        kernel = real_kernel(*a)

        def run(*args):
            out = kernel(*args)
            ranks.append(out)
            return out
        return run

    ranks = []
    ranking._rank_kernel = rank_kernel
    try:
        res4 = rank_eval(wrmf1, train_pos, test_pos, users)
    finally:
        ranking._rank_kernel = real_kernel
    if not _spans(ranks, n):
        failures.append(f"ranking eval does not span {n} devices")
    with first_card_only():
        res1 = rank_eval(wrmf1, train_pos, test_pos, users)
    same = all(res4[k] == res1[k] for k in res1.ALL_MEASURES)
    print(f"four ranking: {n}-card metrics identical to 1-card: {same} "
          f"(AUC {res4['AUC']:.6f} vs {res1['AUC']:.6f})", flush=True)
    if not same:
        failures.append("ranking metrics differ")
    report.line("four-ranking", eval_users=len(users))

    # MultiCoreBPRMF: sharded sampler, AUC within a band
    report.start()
    with outputs_of(bpr_ops, "bpr_epoch_sharded") as out:
        bpr4, times4 = item_model("MultiCoreBPRMF", sizes.bpr_epochs)
    if not _spans(out, n):
        failures.append(f"MultiCoreBPRMF epochs do not span {n} devices")
    with first_card_only():
        bpr1, times1 = item_model("MultiCoreBPRMF", sizes.bpr_epochs)
        auc1 = rank_eval(bpr1, train_pos, test_pos, users)["AUC"]
    auc4 = rank_eval(bpr4, train_pos, test_pos, users)["AUC"]
    ok = abs(auc4 - auc1) <= FOUR_AUC_BAND
    print(f"four BPR: AUC {n}-card {auc4:.5f} 1-card {auc1:.5f} "
          f"(|diff| <= {FOUR_AUC_BAND:g}): {ok}", flush=True)
    if not ok:
        failures.append("MultiCoreBPRMF AUC outside band")
    report.line("four-bpr", epoch_s_4=times4, epoch_s_1=times1)

    # SVD++: sharded grouped epoch, RMSE within a band
    report.start()
    sub = svdpp_subset(train, sizes.svdpp_ratings, sizes.seed)

    def svdpp():
        m = create_rating_predictor("SVDPlusPlus")
        m.num_factors = sizes.svdpp_factors
        m.num_iter = 1
        m.ratings = sub
        times = time_iterations(m, _params)
        m.train()
        return m, times, evaluate_ratings(m, probe)["RMSE"]

    with outputs_of(svdpp_ops, "svdpp_epoch_sharded") as out:
        svd4, times4, rmse4 = svdpp()
    if not _spans(out, n):
        failures.append(f"SVD++ epochs do not span {n} devices")
    with first_card_only():
        svd1, times1, rmse1 = svdpp()
    ok = abs(rmse4 - rmse1) <= FOUR_RMSE_BAND
    print(f"four SVD++: RMSE {n}-card {rmse4:.5f} 1-card {rmse1:.5f} "
          f"(|diff| <= {FOUR_RMSE_BAND:g}): {ok}", flush=True)
    if not ok:
        failures.append("SVD++ RMSE outside band")
    report.line("four-svdpp", epoch_s_4=times4, epoch_s_1=times1)
    if failures:
        raise AssertionError(f"four-card checks failed: {failures}")


# --- driver -------------------------------------------------------------

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ratings", type=int, default=Sizes.num_ratings,
                   help="training ratings (100480507 = full Netflix)")
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card paths (needs 4 GPUs)")
    return p.parse_args(argv)


def run(sizes: Sizes, four: bool, report: Report):
    report.start()
    train, probe = make_data(sizes)
    report.line("data", train=len(train), probe=len(probe),
                users=sizes.num_users, items=sizes.num_items)
    if four:
        four_phase(train, probe, sizes, report)
        return
    rating_model = rating_phase(train, probe, sizes, report)
    models, eval_data = item_phase(train, probe, sizes, report)
    svdpp_phase(train, probe, sizes, report)
    cli_phase(sizes, report)
    check_phase(train, probe, rating_model, models["BPRMF"], eval_data,
                sizes, report)


def main(argv=None) -> int:
    args = parse_args(argv)
    enable_compile_cache()
    try:
        summary = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    card = describe_gpu()
    print(card, flush=True)
    run(Sizes(num_ratings=args.ratings), args.four,
        Report(card.removeprefix("gpu: ")))
    print(json.dumps({"ok": True, "device": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
