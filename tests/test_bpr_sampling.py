"""Statistical validation of the BPR triple-sampling regimes.

The reference has four sampling regimes (``BPRMF.cs:183-321`` +
``WeightedBPRMF.cs:55-66``); the on-device fixed-trial samplers in
ops/bpr.py must reproduce their distributions:

- uniform-user: u ~ Uniform(valid users), i | u ~ Uniform(I_u),
  j | u ~ Uniform(I \\ I_u)
- uniform-pair (with replacement): (u, i) ~ Uniform(events)
- uniform-pair without replacement: a per-epoch permutation — every
  event exactly once
- WBPR: (u, i) ~ Uniform(events), j | u ~ popularity over I \\ I_u

Chi-square goodness-of-fit on large deterministic samples (fixed keys,
no flakes)."""

import numpy as np
import pytest
from scipy import stats

import jax
import jax.numpy as jnp

from mymedialite_tpu.data import PosOnlyData
from mymedialite_tpu.ops import bpr as bpr_ops


@pytest.fixture(scope="module")
def feedback():
    """8 users x 12 items with varying history sizes (2..9)."""
    rng = np.random.default_rng(7)
    users, items = [], []
    sizes = [2, 3, 4, 5, 6, 7, 8, 9]
    for u, sz in enumerate(sizes):
        for i in rng.choice(12, size=sz, replace=False):
            users.append(u)
            items.append(int(i))
    return PosOnlyData(users, items, num_users=8, num_items=12)


@pytest.fixture(scope="module")
def sampler(feedback):
    data, meta = bpr_ops.make_sampler_data(feedback)
    return data, meta


def draw(sampler_data, meta, regime, n=60_000, key=0, pop_cdf=None,
         perm=None):
    """Sample n triples in one batch (or via per-batch perm slices)."""
    u, i, j, w = bpr_ops._sample_triples(
        jax.random.PRNGKey(key), sampler_data, meta, n, regime,
        perm=perm, batch_index=0, pop_cdf=pop_cdf)
    keep = np.asarray(w) > 0
    return (np.asarray(u)[keep], np.asarray(i)[keep], np.asarray(j)[keep])


def positives(feedback, u):
    return set(int(x) for x in feedback.items_by_user(u))


def success_prob(feedback, meta):
    """Fixed-trial negative sampling gives a triple weight 0 with
    probability (|I_u|/I)^T (module docstring, ops/bpr.py) — negligible
    at real densities (~1e-16 on MovieLens) but material on this
    deliberately dense 12-item fixture; the post-filter marginals are
    scaled by the per-user success probability."""
    dens = feedback.count_by_user / feedback.num_items
    return 1.0 - dens ** meta["num_neg_trials"]


class TestUniformUser:
    def test_user_marginal_uniform(self, feedback, sampler):
        data, meta = sampler
        u, _, _ = draw(data, meta, bpr_ops.UNIFORM_USER)
        obs = np.bincount(u, minlength=8).astype(np.float64)
        w = success_prob(feedback, meta)
        expected = w / w.sum() * obs.sum()
        p = stats.chisquare(obs, expected).pvalue
        assert p > 1e-4, (obs, expected, p)

    def test_positive_uniform_within_user(self, feedback, sampler):
        data, meta = sampler
        u, i, _ = draw(data, meta, bpr_ops.UNIFORM_USER)
        for uid in (0, 7):  # smallest and largest history
            pos = sorted(positives(feedback, uid))
            obs = np.bincount(i[u == uid], minlength=12)[pos]
            p = stats.chisquare(obs).pvalue
            assert p > 1e-4, (uid, obs, p)

    def test_negative_uniform_over_complement(self, feedback, sampler):
        data, meta = sampler
        u, _, j = draw(data, meta, bpr_ops.UNIFORM_USER)
        for uid in (0, 7):
            pos = positives(feedback, uid)
            neg = sorted(set(range(12)) - pos)
            sampled = j[u == uid]
            assert not (set(sampled) & pos), "negative hit a positive"
            obs = np.bincount(sampled, minlength=12)[neg]
            p = stats.chisquare(obs).pvalue
            assert p > 1e-4, (uid, obs, p)


class TestUniformPair:
    def test_pairs_uniform_over_events(self, feedback, sampler):
        data, meta = sampler
        u, i, _ = draw(data, meta, bpr_ops.UNIFORM_PAIR)
        # each event is a distinct (u, i); expected uniform over events
        key = u.astype(np.int64) * 12 + i
        ev_key = np.asarray(feedback.users, np.int64) * 12 + \
            np.asarray(feedback.items)
        obs = np.array([(key == k).sum() for k in ev_key],
                       dtype=np.float64)
        assert obs.sum() == key.size  # only real events sampled
        w = success_prob(feedback, meta)[np.asarray(feedback.users)]
        expected = w / w.sum() * obs.sum()
        p = stats.chisquare(obs, expected).pvalue
        assert p > 1e-4, (obs, p)


class TestUniformPairWithoutReplacement:
    def test_one_epoch_covers_each_event_once(self, feedback, sampler):
        """Reference 'without replacement' = per-epoch permutation of the
        events (BPRMF.cs:229-259)."""
        data, meta = sampler
        n_events = meta["num_events"]
        batch = 16
        n_batches = (n_events + batch - 1) // batch
        perm = jax.random.permutation(
            jax.random.PRNGKey(3),
            np.arange(n_batches * batch, dtype=np.int32))
        seen = []
        for b in range(n_batches):
            u, i, j, w = bpr_ops._sample_triples(
                jax.random.PRNGKey(100 + b), data, meta, batch,
                bpr_ops.UNIFORM_PAIR_WOR, perm=perm, batch_index=b)
            keep = np.asarray(w) > 0
            seen += list(zip(np.asarray(u)[keep].tolist(),
                             np.asarray(i)[keep].tolist()))
        expect = sorted(zip(np.asarray(feedback.users).tolist(),
                            np.asarray(feedback.items).tolist()))
        # negative sampling can zero-weight a triple (trial exhaustion);
        # with 12 items and <=9 positives the failure rate is (9/12)^8<11%
        # per triple — require at least one full-coverage property:
        # no event sampled twice and >=80% coverage
        assert len(seen) == len(set(seen))
        assert len(set(seen)) >= 0.8 * len(expect)
        assert set(seen) <= set(expect)


class TestWBPR:
    def test_user_marginal_by_activity(self, feedback, sampler):
        data, meta = sampler
        pop_cdf = bpr_ops.popularity_cdf(feedback)
        u, _, _ = draw(data, meta, bpr_ops.WBPR, pop_cdf=pop_cdf)
        obs = np.bincount(u, minlength=8).astype(np.float64)
        # WBPR negatives are popularity-sampled: the fixed-trial failure
        # probability is (popularity mass of I_u)^T per trial
        counts = np.asarray(feedback.count_by_item, dtype=np.float64)
        total = counts.sum()
        s = np.array([1.0 - (counts[sorted(positives(feedback, uid))].sum()
                             / total) ** meta["num_neg_trials"]
                      for uid in range(8)])
        w = feedback.count_by_user * s
        expected = w / w.sum() * obs.sum()
        p = stats.chisquare(obs, expected).pvalue
        assert p > 1e-4, (obs, expected, p)

    def test_negative_by_popularity_over_complement(self, feedback, sampler):
        data, meta = sampler
        pop_cdf = bpr_ops.popularity_cdf(feedback)
        u, _, j = draw(data, meta, bpr_ops.WBPR, pop_cdf=pop_cdf)
        counts = np.asarray(feedback.count_by_item, dtype=np.float64)
        for uid in (0, 7):
            pos = positives(feedback, uid)
            neg = sorted(set(range(12)) - pos)
            sampled = j[u == uid]
            assert not (set(sampled) & pos)
            obs = np.bincount(sampled, minlength=12)[neg].astype(np.float64)
            w = counts[neg]
            expected = w / w.sum() * obs.sum()
            # drop zero-popularity bins (chisquare needs expected > 0)
            keep = expected > 0
            assert obs[~keep].sum() == 0
            p = stats.chisquare(obs[keep], expected[keep]).pvalue
            assert p > 1e-4, (uid, obs, expected, p)


class TestNegativesNeverPositive:
    """Every kept triple's negative lies outside the user's history, in
    every regime (the fixed-trial sampler's one hard guarantee)."""

    @pytest.mark.parametrize("regime", [bpr_ops.UNIFORM_USER,
                                        bpr_ops.UNIFORM_PAIR,
                                        bpr_ops.WBPR,
                                        bpr_ops.UNIFORM_PAIR_WOR])
    def test_all_users(self, feedback, sampler, regime):
        data, meta = sampler
        n = 4096
        perm = (jax.random.permutation(jax.random.PRNGKey(8),
                                       np.arange(n, dtype=np.int32))
                % meta["num_events"]
                if regime == bpr_ops.UNIFORM_PAIR_WOR else None)
        pop_cdf = bpr_ops.popularity_cdf(feedback) \
            if regime == bpr_ops.WBPR else None
        u, i, j = draw(data, meta, regime, n=n, key=4, pop_cdf=pop_cdf,
                       perm=perm)
        assert u.size > 0
        for uid in range(8):
            pos = positives(feedback, uid)
            assert set(i[u == uid].tolist()) <= pos
            assert not set(j[u == uid].tolist()) & pos


class TestPerUserSuccessRate:
    """Uniform negatives: a triple keeps weight 1 with probability exactly
    1 - (|I_u|/I)^T (T fixed trials), per user."""

    @pytest.mark.parametrize("uid", range(8))
    def test_rate_matches_closed_form(self, feedback, sampler, uid):
        data, meta = sampler
        n = 40_000
        users = jnp.full((n,), uid, dtype=jnp.int32)
        _, ok = bpr_ops._sample_negatives(
            jax.random.PRNGKey(20 + uid), data, users, meta["num_items"],
            meta["num_neg_trials"], meta["search_depth"])
        p = 1.0 - (len(positives(feedback, uid)) / 12) ** \
            meta["num_neg_trials"]
        rate = float(np.asarray(ok).mean())
        assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / n) + 1e-9, \
            (rate, p)


class TestShardedSampler:
    """make_sampler_data_sharded (MultiCoreBPRMF on a mesh): users split
    into contiguous per-device ranges, each device's histories and
    events exactly its users' share of the global feedback."""

    @pytest.mark.parametrize("n_dev", [2, 4])
    def test_partition_covers_every_event_once(self, feedback, n_dev):
        data, meta = bpr_ops.make_sampler_data_sharded(feedback, n_dev)
        got = []
        for d in range(n_dev):
            k = int(data["ev_count"][d])
            u = np.asarray(data["ev_user"][d][:k]) + d * meta["u_loc"]
            got += list(zip(u.tolist(),
                            np.asarray(data["ev_item"][d][:k]).tolist()))
        want = list(zip(np.asarray(feedback.users).tolist(),
                        np.asarray(feedback.items).tolist()))
        assert sorted(got) == sorted(want)

    @pytest.mark.parametrize("n_dev", [2, 4])
    def test_local_histories_match_global(self, feedback, n_dev):
        data, meta = bpr_ops.make_sampler_data_sharded(feedback, n_dev)
        for d in range(n_dev):
            indptr = np.asarray(data["indptr"][d])
            hist = np.asarray(data["hist_items"][d])
            for lu in range(meta["u_loc"]):
                uid = d * meta["u_loc"] + lu
                seg = hist[indptr[lu]:indptr[lu + 1]]
                want = sorted(positives(feedback, uid)) \
                    if uid < feedback.num_users else []
                assert seg.tolist() == want
