"""Item-recommender model tests (counterpart of reference
Tests/ItemRecommendation/ItemRecommendersTest.cs sweep: smoke, save/load
round-trip, quality sanity on synthetic data)."""

import numpy as np
import pytest

from mymedialite_tpu.data import PosOnlyData
from mymedialite_tpu.data.synthetic import split_posonly, synthetic_posonly
from mymedialite_tpu.eval import evaluate_items
from mymedialite_tpu.models.registry import (
    create_item_recommender, list_item_recommenders,
)
from mymedialite_tpu.utils.params import configure


def small_feedback():
    # reference TestUtils.CreatePosOnlyFeedback-style tiny fixture
    return PosOnlyData([0, 0, 1, 1, 1], [0, 2, 1, 2, 3],
                       num_users=2, num_items=4)


def give_attributes(m):
    """Attribute-based models need side information."""
    from mymedialite_tpu.data import InteractionData
    if hasattr(m, "user_attributes"):
        m.user_attributes = InteractionData([0, 1], [0, 1])
    if hasattr(m, "item_attributes"):
        m.item_attributes = InteractionData([0, 1, 2, 3], [0, 0, 1, 1])


@pytest.fixture(scope="module")
def implicit_ml_like():
    data = synthetic_posonly(num_events=20000, seed=11)
    return split_posonly(data, seed=12)


_SKIP_SMOKE = ("ExternalItemRecommender",)
_SKIP_ROUNDTRIP = ("Random", "ExternalItemRecommender",
                   "MostPopularByAttributes")  # ref also NotImplemented


class TestSmoke:
    @pytest.mark.parametrize("name", [n for n in list_item_recommenders()
                                      if n not in _SKIP_SMOKE])
    def test_train_predict_recommend(self, name):
        m = create_item_recommender(name)
        m.feedback = small_feedback()
        give_attributes(m)
        if hasattr(m, "num_iter"):
            m.num_iter = 2
        if hasattr(m, "batch_size"):
            m.batch_size = 8
        m.train()
        assert np.isfinite(m.predict(0, 0))
        recs = m.recommend(0, n=2)
        assert len(recs) == 2

    @pytest.mark.parametrize("name", [n for n in list_item_recommenders()
                                      if n not in _SKIP_ROUNDTRIP])
    def test_save_load_roundtrip(self, name, tmp_path):
        m = create_item_recommender(name)
        m.feedback = small_feedback()
        give_attributes(m)
        if hasattr(m, "num_iter"):
            m.num_iter = 2
        if hasattr(m, "batch_size"):
            m.batch_size = 8
        m.train()
        users = np.array([0, 1, 0, 1], dtype=np.int32)
        items = np.array([0, 1, 3, 2], dtype=np.int32)
        before = m.predict_batch(users, items)
        path = str(tmp_path / f"{name}.model")
        m.save_model(path)
        m2 = create_item_recommender(name)
        m2.feedback = small_feedback()
        give_attributes(m2)
        m2.load_model(path)
        np.testing.assert_allclose(before, m2.predict_batch(users, items),
                                   atol=1e-6)


class TestLoadThenIterate:
    """LoadModel then Iterate keeps training without a fresh train()
    (reference Model.Load re-creates a recommender that can keep
    training, IO/Model.cs:67-83; the CLI's --load-model + --find-iter
    flow). Registry-wide sweep over every iterative item recommender —
    the round-2 per-family fix regressed silently for BPRMF/WRMF because
    only the rating-MF family was swept."""

    @pytest.mark.parametrize("name", [n for n in list_item_recommenders()
                                      if n not in _SKIP_ROUNDTRIP])
    def test_iterate_after_load(self, name, tmp_path):
        from mymedialite_tpu.models.base import IterativeModel
        m = create_item_recommender(name)
        if not isinstance(m, IterativeModel):
            pytest.skip("not an iterative model")
        m.feedback = small_feedback()
        give_attributes(m)
        m.num_iter = 2
        if hasattr(m, "batch_size"):
            m.batch_size = 8
        m.train()
        path = str(tmp_path / f"{name}.model")
        m.save_model(path)

        m2 = create_item_recommender(name)
        m2.feedback = small_feedback()
        give_attributes(m2)
        if hasattr(m2, "batch_size"):
            m2.batch_size = 8
        m2.load_model(path)
        m2.iterate()                      # must not crash
        users = np.array([0, 1, 0, 1], dtype=np.int32)
        items = np.array([0, 1, 3, 2], dtype=np.int32)
        assert np.all(np.isfinite(m2.predict_batch(users, items)))
        if hasattr(m2, "compute_objective"):
            m2.compute_objective()        # must not crash either

    @pytest.mark.parametrize("name", ["BPRMF", "WRMF"])
    def test_add_feedback_after_load(self, name, tmp_path):
        """load_model -> add_feedback -> iterate (the online-then-resume
        flow; reference IncrementalItemRecommender.cs:38-101)."""
        m = create_item_recommender(name)
        m.feedback = small_feedback()
        m.num_iter = 2
        if hasattr(m, "batch_size"):
            m.batch_size = 8
        m.train()
        path = str(tmp_path / f"{name}.model")
        m.save_model(path)
        m2 = create_item_recommender(name)
        m2.feedback = small_feedback()
        if hasattr(m2, "batch_size"):
            m2.batch_size = 8
        m2.load_model(path)
        new_u = m2.feedback.num_users
        m2.add_feedback([new_u, new_u], [0, 1])
        m2.iterate()
        assert np.isfinite(m2.predict(new_u, 2))


class TestBPREpochModelLayer:
    """The BPR family trains through the XLA minibatch epoch
    (ops/bpr.py bpr_epoch) via the model's own train(); sampler
    numerics live in tests/test_bpr_sampling.py."""

    def _small(self):
        data = synthetic_posonly(num_users=80, num_items=50,
                                 num_events=3000, seed=31)
        return split_posonly(data, seed=32)

    @staticmethod
    def _random_auc(train, test):
        rnd = create_item_recommender("Random")
        rnd.feedback = train
        rnd.train()
        return evaluate_items(rnd, test, train)["AUC"]

    @pytest.mark.parametrize("name,margin", [
        ("BPRMF", 0.1), ("SoftMarginRankingMF", 0.05),
        ("WeightedBPRMF", 0.05)])
    def test_model_trains(self, name, margin):
        train, test = self._small()
        m = create_item_recommender(name)
        m.feedback = train
        m.num_factors = 8
        m.num_iter = 5
        m.batch_size = 256
        m.train()
        res = evaluate_items(m, test, train)
        assert res["AUC"] > self._random_auc(train, test) + margin

    def test_big_catalog(self):
        """A catalog much larger than the user count still learns."""
        data = synthetic_posonly(num_users=80, num_items=3000,
                                 num_events=30000, seed=41)
        train, test = split_posonly(data, seed=42)
        m = create_item_recommender("BPRMF")
        m.feedback = train
        m.num_factors = 8
        m.num_iter = 10
        m.batch_size = 1024
        m.train()
        res = evaluate_items(m, test, train)
        assert res["AUC"] > self._random_auc(train, test) + 0.1

    def test_add_feedback_rebuilds_sampler(self):
        """AddFeedback then Iterate must train on the CURRENT feedback
        (reference BPRMF.cs:129-160): the sampler is rebuilt from the
        updated event stream, never reused stale."""
        train, _ = self._small()
        m = create_item_recommender("BPRMF")
        m.feedback = train
        m.num_factors = 4
        m.num_iter = 2
        m.train()
        assert m._meta["num_events"] == len(train)
        new_u = train.num_users
        m.add_feedback([new_u, new_u, new_u], [1, 2, 3])
        m.iterate()
        assert m._meta["num_events"] == len(m.feedback)
        assert m.params["user_factors"].shape[0] == new_u + 1


class TestMostPopular:
    def test_counts(self):
        m = create_item_recommender("MostPopular")
        m.feedback = small_feedback()
        m.train()
        # item 2 appears twice
        assert m.predict(0, 2) > m.predict(0, 0)
        recs = [i for i, _ in m.recommend(0)]
        assert recs[0] == 2

    def test_by_user(self):
        f = PosOnlyData([0, 0, 1], [0, 0, 1], num_users=2, num_items=2)
        m = create_item_recommender("MostPopular")
        configure(m, "by_user=true")
        m.feedback = f
        m.train()
        # deduped: item 0 has 1 distinct user, item 1 has 1
        assert m.view_count[0] == 1
        assert m.view_count[1] == 1

    def test_incremental(self):
        m = create_item_recommender("MostPopular")
        m.feedback = small_feedback()
        m.train()
        before = m.view_count[3]
        m.add_feedback([0], [3])
        assert m.view_count[3] == before + 1


class TestBPRMF:
    def test_learns_ranking(self, implicit_ml_like):
        train, test = implicit_ml_like
        m = create_item_recommender("BPRMF")
        m.feedback = train
        m.num_factors = 16
        m.num_iter = 12
        m.batch_size = 4096
        m.train()
        res = evaluate_items(m, test, train)
        rnd = create_item_recommender("Random")
        rnd.feedback = train
        rnd.train()
        res_rnd = evaluate_items(rnd, test, train)
        assert res["AUC"] > res_rnd["AUC"] + 0.1
        assert res["AUC"] > 0.6

    def test_objective_decreases(self, implicit_ml_like):
        train, _ = implicit_ml_like
        m = create_item_recommender("BPRMF")
        m.feedback = train
        m.num_factors = 8
        m.batch_size = 4096
        m.init_model()
        obj0 = m.compute_objective()
        for _ in range(5):
            m.iterate()
        assert m.compute_objective() < obj0

    def test_incremental_add_user(self, implicit_ml_like):
        train, _ = implicit_ml_like
        m = create_item_recommender("BPRMF")
        m.feedback = train
        m.num_iter = 2
        m.batch_size = 4096
        m.train()
        new_u = train.num_users
        m.add_feedback([new_u, new_u], [0, 1])
        assert np.isfinite(m.predict(new_u, 2))

    def test_echo(self):
        m = create_item_recommender("BPRMF")
        s = str(m)
        assert "reg_u=0.0025" in s
        assert "uniform_user_sampling=True" in s

    def test_sampling_regimes(self, implicit_ml_like):
        train, _ = implicit_ml_like
        for opts in ("uniform_user_sampling=false",
                     "uniform_user_sampling=false with_replacement=true"):
            m = create_item_recommender("BPRMF")
            configure(m, opts)
            m.feedback = train
            m.num_iter = 2
            m.batch_size = 4096
            m.train()
            assert np.isfinite(m.predict(0, 0))

    def test_fold_in(self, implicit_ml_like):
        train, _ = implicit_ml_like
        m = create_item_recommender("BPRMF")
        m.feedback = train
        m.num_iter = 3
        m.batch_size = 4096
        m.train()
        scored = m.score_items_foldin([0, 1, 2], [3, 4, 5])
        assert len(scored) == 3


class TestWRMF:
    def test_learns(self, implicit_ml_like):
        train, test = implicit_ml_like
        m = create_item_recommender("WRMF")
        m.feedback = train
        m.num_factors = 16
        m.num_iter = 10
        m.train()
        res = evaluate_items(m, test, train)
        mp = create_item_recommender("MostPopular")
        mp.feedback = train
        mp.train()
        res_mp = evaluate_items(mp, test, train)
        # WRMF should clearly beat raw popularity on latent-structure data
        assert res["AUC"] > res_mp["AUC"]

    def test_closed_form_fit(self):
        # single alternation must reduce the weighted squared error
        train = small_feedback()
        m = create_item_recommender("WRMF")
        m.feedback = train
        m.num_factors = 4
        m.num_iter = 5
        m.train()
        # observed entries should score higher than unobserved on average
        pos = m.predict_batch(train.users, train.items)
        neg = m.predict_batch(np.array([0, 1]), np.array([1, 0]))
        assert pos.mean() > neg.mean()

    def test_bucketed_equals_rectangular(self, implicit_ml_like):
        """The length-bucketed history layout (memory O(2*nnz)) must give
        the same solves as one rectangular [U, Lmax] layout — every row's
        system only involves its own history."""
        import jax.numpy as jnp
        from mymedialite_tpu.data.arrays import padded_history
        from mymedialite_tpu.ops.als import pad_rows, wrmf_optimize
        train, _ = implicit_ml_like
        m = create_item_recommender("WRMF")
        m.feedback = train
        m.num_factors = 8
        m.init_model()
        H0 = np.asarray(m.params["item_factors"]).copy()
        m.iterate()
        uh, ul = padded_history(train.by_user)
        uh, ul, _ = pad_rows(uh, ul, 256)
        expected = np.asarray(wrmf_optimize(
            jnp.asarray(H0), jnp.asarray(uh), jnp.asarray(ul),
            jnp.float32(m.alpha), jnp.float32(m.regularization),
            chunk=256))[:train.num_users]
        np.testing.assert_allclose(np.asarray(m.params["user_factors"]),
                                   expected, atol=1e-5)

    def test_one_giant_history_bounded(self):
        """A single user with a huge history must not force every user's
        padded row to that length (the bucketed layout isolates it)."""
        rng = np.random.default_rng(3)
        users = np.concatenate([rng.integers(0, 200, 2000),
                                np.zeros(3000, np.int64)])
        items = np.concatenate([rng.integers(0, 50, 2000),
                                np.arange(3000) % 3500])
        fb = PosOnlyData(users, items)
        m = create_item_recommender("WRMF")
        m.feedback = fb
        m.num_factors = 4
        m.num_iter = 2
        m.train()
        # the giant-history user lands alone in the top bucket
        sizes = {len(rows): hist[0].shape[1]
                 for rows, hist, _ in m._user_hist}
        assert max(h for h in sizes.values()) >= 2048
        small_bucket_rows = sum(r for r, h in sizes.items() if h <= 32)
        assert small_bucket_rows >= 150
        assert np.isfinite(m.predict(0, 0))

    def test_incremental_retrains_only_touched_rows(self, implicit_ml_like):
        """AddFeedback re-solves ONLY the touched user/item rows
        (reference WRMF.RetrainUser/RetrainItem, WRMF.cs:158-172);
        every other row must be bit-unchanged."""
        train, _ = implicit_ml_like
        m = create_item_recommender("WRMF")
        m.feedback = train
        m.num_factors = 8
        m.num_iter = 3
        m.update_users = True
        m.update_items = True
        m.train()
        W0 = np.asarray(m.params["user_factors"]).copy()
        H0 = np.asarray(m.params["item_factors"]).copy()
        u, i = 5, 7
        m.add_feedback([u], [i])
        W1 = np.asarray(m.params["user_factors"])
        H1 = np.asarray(m.params["item_factors"])
        assert not np.array_equal(W1[u], W0[u])          # touched row moved
        mask_u = np.ones(W0.shape[0], bool)
        mask_u[u] = False
        np.testing.assert_array_equal(W1[mask_u], W0[mask_u])
        mask_i = np.ones(H0.shape[0], bool)
        mask_i[i] = False
        np.testing.assert_array_equal(H1[mask_i], H0[mask_i])

    def test_update_flags_default_off(self):
        """Reference IncrementalItemRecommender: UpdateUsers/UpdateItems
        default to false for WRMF — AddFeedback records the event but
        retrains nothing."""
        train = small_feedback()
        m = create_item_recommender("WRMF")
        m.feedback = train
        m.num_factors = 4
        m.num_iter = 3
        m.train()
        W0 = np.asarray(m.params["user_factors"]).copy()
        m.add_feedback([0], [1])
        np.testing.assert_array_equal(
            np.asarray(m.params["user_factors"]), W0)


class TestShardedBPR:
    """MultiCoreBPRMF's mesh-sharded epoch (ops/bpr.py bpr_epoch_sharded):
    users range-partitioned across the 8-device CPU mesh, item deltas
    psum'd per minibatch (reference MultiCoreBPRMF.cs:30 mapping)."""

    def test_sharded_path_engages_and_learns(self):
        import jax
        from mymedialite_tpu.data import PosOnlyData
        from mymedialite_tpu.eval import evaluate_items
        from mymedialite_tpu.models.registry import create_item_recommender

        assert len(jax.devices()) >= 8  # conftest virtual mesh
        rng = np.random.default_rng(11)
        # planted structure: even users like even items
        users, items = [], []
        for _ in range(3000):
            u = int(rng.integers(0, 64))
            i = int(rng.integers(0, 48))
            if (u + i) % 2 == 0 or rng.random() < 0.15:
                users.append(u)
                items.append(i)
        pairs = sorted(set(zip(users, items)))
        rng.shuffle(pairs)
        cut = len(pairs) // 5
        test = PosOnlyData([u for u, _ in pairs[:cut]],
                           [i for _, i in pairs[:cut]],
                           num_users=64, num_items=48)
        train = PosOnlyData([u for u, _ in pairs[cut:]],
                            [i for _, i in pairs[cut:]],
                            num_users=64, num_items=48)
        m = create_item_recommender("MultiCoreBPRMF")
        m.num_iter = 12
        m.num_factors = 8
        m.random_seed = 3
        m.feedback = train
        m.train()
        assert m._mesh is not None and m._mesh.devices.size >= 8
        res = evaluate_items(m, test, train)
        assert res["AUC"] > 0.6, res  # learned the parity structure


class TestShardedALS:
    def test_sharded_matches_single_device(self):
        """WRMF's mesh-sharded row solves (ops/als.py wrmf_optimize_sharded,
        reference Parallel.For WRMF.cs:87-91) must be bit-identical to the
        single-device batched solve."""
        import jax
        import jax.numpy as jnp
        from mymedialite_tpu.ops.als import (
            pad_rows, wrmf_optimize, wrmf_optimize_sharded,
        )
        from mymedialite_tpu.parallel.mesh import (
            make_mesh, replicated, row_sharded, row_sharded_2d,
        )

        rng = np.random.default_rng(0)
        I, f, U, L, chunk = 40, 6, 100, 12, 8
        H = rng.normal(size=(I, f)).astype(np.float32)
        hist = rng.integers(0, I, (U, L)).astype(np.int32)
        lens = rng.integers(0, L + 1, U).astype(np.int32)
        n = len(jax.devices())
        hist8, lens8, _ = pad_rows(hist, lens, chunk * n)
        single = wrmf_optimize(jnp.asarray(H), jnp.asarray(hist8),
                               jnp.asarray(lens8), jnp.float32(1.0),
                               jnp.float32(0.015), chunk=chunk)
        mesh = make_mesh()
        sharded = wrmf_optimize_sharded(
            mesh, jax.device_put(H, replicated(mesh)),
            jax.device_put(hist8, row_sharded_2d(mesh)),
            jax.device_put(lens8, row_sharded(mesh)),
            jnp.float32(1.0), jnp.float32(0.015), chunk=chunk)
        np.testing.assert_allclose(np.asarray(single), np.asarray(sharded),
                                   atol=1e-6)
