"""CLI end-to-end tests (counterpart of the reference tier-2 shell
scripts: tests/test_rating_prediction.sh, test_item_recommendation.sh,
test_load_save.sh determinism oracle)."""

import os
import re

import numpy as np
import pytest

from mymedialite_tpu.cli import item_recommendation, rating_prediction


def _strip_times(text: str) -> str:
    # the reference golden tests strip timing fields before diffing
    # (tests/test_load_save.sh lines 14-31); the load run has no
    # training_time at all, so remove the whole token
    return re.sub(r"(training_time|testing_time|loading_time|prediction_time)"
                  r" [0-9.]+ ?", "", text)


@pytest.fixture()
def implicit_files(tmp_path):
    # disjoint train/test (u,i) pairs: the reference protocol (and ours,
    # faithfully) rejects per-user train/test overlap in full-list eval
    rng = np.random.default_rng(5)
    pairs = {(int(rng.integers(0, 30)), int(rng.integers(0, 40)))
             for _ in range(400)}
    pairs = sorted(pairs)
    rng.shuffle(pairs)
    train_pairs, test_pairs = pairs[80:], pairs[:80]
    train_path = tmp_path / "imp.train"
    test_path = tmp_path / "imp.test"
    with open(train_path, "w") as f:
        for u, i in train_pairs:
            f.write(f"{u}\t{i}\n")
    with open(test_path, "w") as f:
        for u, i in test_pairs:
            f.write(f"{u}\t{i}\n")
    return str(train_path), str(test_path)


class TestRatingPredictionCLI:
    def test_basic(self, example_files, capsys):
        TRAIN, TEST = example_files
        rc = rating_prediction.main([
            "--training-file", TRAIN, "--test-file", TEST,
            "--recommender", "UserItemBaseline"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "RMSE" in out and "MAE" in out and "CBD" in out
        # dataset statistics precede the recommender line on stdout
        # (reference RatingPrediction.cs:200, Data/Extensions.cs:34-81)
        assert out.startswith("training data: ")
        assert re.search(r"training data: \d+ users, \d+ items, \d+ ratings,"
                         r" sparsity \d+(\.\d+)?\n", out)
        assert re.search(r"test data: +\d+ users, \d+ items, \d+ ratings,"
                         r" sparsity \d+(\.\d+)?\n", out)
        assert "\nUserItemBaseline " in out

    def test_find_iter(self, example_files, capsys):
        TRAIN, TEST = example_files
        rc = rating_prediction.main([
            "--training-file", TRAIN, "--test-file", TEST,
            "--recommender", "MatrixFactorization",
            "--recommender-options", "num_iter=2 batch_size=8",
            "--find-iter", "1", "--max-iter", "4"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "iteration 2" in out
        assert "iteration 4" in out

    def test_save_load_determinism(self, example_files, tmp_path, capsys):
        """The reference test_load_save.sh oracle: train+save, then load;
        stripped outputs must be identical."""
        TRAIN, TEST = example_files
        model = str(tmp_path / "m.model")
        rating_prediction.main([
            "--training-file", TRAIN, "--test-file", TEST,
            "--recommender", "BiasedMatrixFactorization",
            "--recommender-options", "num_iter=3 batch_size=8",
            "--random-seed", "1", "--save-model", model])
        out1 = _strip_times(capsys.readouterr().out)
        rating_prediction.main([
            "--training-file", TRAIN, "--test-file", TEST,
            "--recommender", "BiasedMatrixFactorization",
            "--recommender-options", "num_iter=3 batch_size=8",
            "--random-seed", "1", "--load-model", model])
        out2 = _strip_times(capsys.readouterr().out)
        assert out1 == out2

    def test_cross_validation(self, example_files, capsys):
        TRAIN, TEST = example_files
        rc = rating_prediction.main([
            "--training-file", TRAIN, "--recommender", "UserItemBaseline",
            "--cross-validation", "2", "--random-seed", "1"])
        assert rc == 0
        assert "RMSE" in capsys.readouterr().out

    def test_prediction_file(self, example_files, tmp_path, capsys):
        TRAIN, TEST = example_files
        pred = str(tmp_path / "preds.txt")
        rating_prediction.main([
            "--training-file", TRAIN, "--test-file", TEST,
            "--recommender", "GlobalAverage", "--prediction-file", pred])
        capsys.readouterr()
        lines = open(pred).read().strip().split("\n")
        assert len(lines) == 4  # example.test has 4 ratings
        assert all(len(line.split("\t")) == 3 for line in lines)

    def test_test_ratio(self, example_files, capsys):
        TRAIN, TEST = example_files
        rc = rating_prediction.main([
            "--training-file", TRAIN, "--recommender", "GlobalAverage",
            "--test-ratio", "0.25", "--random-seed", "7"])
        assert rc == 0
        assert "RMSE" in capsys.readouterr().out

    def test_version_and_help_measures(self, capsys):
        with pytest.raises(SystemExit) as exc:
            rating_prediction.main(["--version"])
        assert exc.value.code == 0
        assert "MyMediaLite-JAX rating_prediction" in capsys.readouterr().out
        with pytest.raises(SystemExit) as exc:
            rating_prediction.main(["--help-measures"])
        assert exc.value.code == 0
        assert "RMSE" in capsys.readouterr().out

    def test_prediction_line_and_header(self, example_files, tmp_path, capsys):
        TRAIN, TEST = example_files
        pred = str(tmp_path / "preds.txt")
        rating_prediction.main([
            "--training-file", TRAIN, "--test-file", TEST,
            "--recommender", "GlobalAverage", "--prediction-file", pred,
            "--prediction-line", "{1},{0},{2}",
            "--prediction-header", "item,user,score"])
        capsys.readouterr()
        lines = open(pred).read().strip().split("\n")
        assert lines[0] == "item,user,score"
        assert len(lines) == 5
        # columns swapped: first token is the item id
        test_lines = open(TEST).read().strip().split("\n")
        assert lines[1].split(",")[0] == test_lines[0].split()[1]

    def test_test_no_ratings(self, example_files, tmp_path, capsys):
        TRAIN, TEST = example_files
        nr = tmp_path / "nr.test"
        with open(TEST) as f:
            rows = [line.split()[:2] for line in f if line.strip()]
        with open(nr, "w") as f:
            for u, i in rows:
                f.write(f"{u}\t{i}\n")
        pred = str(tmp_path / "preds.txt")
        rc = rating_prediction.main([
            "--training-file", TRAIN, "--test-file", str(nr),
            "--test-no-ratings", "--prediction-file", pred,
            "--recommender", "UserItemBaseline"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "RMSE" not in out  # no rating column -> no evaluation
        lines = open(pred).read().strip().split("\n")
        assert len(lines) == len(rows)

    def test_test_no_ratings_requires_prediction_file(self, example_files,
                                                      capsys):
        TRAIN, TEST = example_files
        with pytest.raises(SystemExit):
            rating_prediction.main([
                "--training-file", TRAIN, "--test-file", TEST,
                "--test-no-ratings", "--recommender", "GlobalAverage"])


class TestItemRecommendationCLI:
    def test_basic(self, implicit_files, capsys):
        train, test = implicit_files
        rc = item_recommendation.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "MostPopular"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "AUC" in out and "prec@5" in out

    def test_bprmf(self, implicit_files, capsys):
        train, test = implicit_files
        rc = item_recommendation.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "BPRMF",
            "--recommender-options", "num_iter=2 batch_size=64",
            "--random-seed", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "AUC" in out

    def test_candidate_modes(self, implicit_files, capsys):
        train, test = implicit_files
        for flag in ("--all-items", "--in-training-items", "--in-test-items"):
            rc = item_recommendation.main([
                "--training-file", train, "--test-file", test,
                "--recommender", "MostPopular", flag])
            assert rc == 0
        capsys.readouterr()

    def test_prediction_file(self, implicit_files, tmp_path, capsys):
        train, test = implicit_files
        pred = str(tmp_path / "preds.txt")
        item_recommendation.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "MostPopular",
            "--predict-items-number", "3",
            "--prediction-file", pred])
        capsys.readouterr()
        first = open(pred).readline()
        assert re.match(r"^\d+\t\[.*:.*\]", first)

    def test_online_eval(self, implicit_files, capsys):
        train, test = implicit_files
        rc = item_recommendation.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "MostPopular", "--online-evaluation"])
        assert rc == 0
        assert "AUC" in capsys.readouterr().out

    def test_side_information_wiring(self, implicit_files, tmp_path, capsys):
        """--item-attributes loads into the recommender; attribute-aware
        recommenders abort without their file (reference
        CommandLineProgram.cs:255-267 + CheckParameters)."""
        train, test = implicit_files
        attrs = tmp_path / "attrs"
        with open(attrs, "w") as f:
            for i in range(40):
                f.write(f"{i}\t{i % 4}\n")
        rc = item_recommendation.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "ItemAttributeKNN",
            "--item-attributes", str(attrs)])
        assert rc == 0
        assert "AUC" in capsys.readouterr().out
        with pytest.raises(SystemExit):
            item_recommendation.main([
                "--training-file", train, "--test-file", test,
                "--recommender", "ItemAttributeKNN"])
        capsys.readouterr()

    def test_num_test_users(self, implicit_files, capsys):
        train, test = implicit_files
        rc = item_recommendation.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "MostPopular", "--num-test-users", "5",
            "--random-seed", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        num_lists = int(re.search(r"num_lists (\d+)", out).group(1))
        assert num_lists <= 5

    def test_user_prediction(self, implicit_files, capsys):
        """--user-prediction recommends users for items: evaluation runs
        on the transposed feedback (reference ItemRecommendation.cs:389-409)."""
        train, test = implicit_files
        rc = item_recommendation.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "MostPopular", "--user-prediction"])
        assert rc == 0
        out_t = capsys.readouterr().out
        assert "AUC" in out_t
        # num_items now counts users (30 > catalog of 40? sanity: differs
        # from the untransposed run's num_items)
        rc = item_recommendation.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "MostPopular"])
        out = capsys.readouterr().out
        ni_t = int(re.search(r"num_items (\d+)", out_t).group(1))
        ni = int(re.search(r"num_items (\d+)", out).group(1))
        assert ni_t != ni


class TestIterativeCrossValidation:
    """Reference RatingsCrossValidation.cs:92-171 / ItemsCrossValidation
    DoIterativeCrossValidation: --cross-validation + --find-iter."""

    def test_rating(self, example_files, capsys):
        TRAIN, TEST = example_files
        rc = rating_prediction.main([
            "--training-file", TRAIN, "--recommender", "MatrixFactorization",
            "--recommender-options", "num_iter=2 batch_size=8",
            "--cross-validation", "2", "--find-iter", "1",
            "--max-iter", "4", "--random-seed", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        # one averaged line per iteration from num_iter..max_iter
        for it in (2, 3, 4):
            assert f"iteration {it}" in out
        assert "RMSE" in out

    def test_item(self, implicit_files, capsys):
        train, _ = implicit_files
        rc = item_recommendation.main([
            "--training-file", train, "--recommender", "BPRMF",
            "--recommender-options", "num_iter=1",
            "--cross-validation", "2", "--find-iter", "1",
            "--max-iter", "2", "--random-seed", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "iteration 1" in out and "iteration 2" in out
        assert "AUC" in out


class TestTransductiveWiring:
    def test_svdpp_receives_test_histories(self, example_files, capsys):
        TRAIN, TEST = example_files
        from mymedialite_tpu.cli import rating_prediction as rp
        import mymedialite_tpu as mml
        m = mml.create_rating_predictor("SVDPlusPlus")
        seen = {}
        orig_train = type(m).train

        # run the real CLI and verify additional_feedback was set before
        # training (reference RatingPrediction.cs:424-425)
        def spy(self):
            seen["af"] = self.additional_feedback
            return orig_train(self)

        type(m).train = spy
        try:
            rp.main([
                "--training-file", TRAIN, "--test-file", TEST,
                "--recommender", "SVDPlusPlus",
                "--recommender-options", "num_iter=1 num_factors=2"])
        finally:
            type(m).train = orig_train
        capsys.readouterr()
        assert seen["af"] is not None
        assert len(seen["af"][0]) == 4  # example.test has 4 ratings


class TestRatingBasedRankingCLI:
    """Reference src/Programs/RatingBasedRanking/RatingBasedRanking.cs."""

    def test_basic(self, example_files, capsys):
        TRAIN, TEST = example_files
        from mymedialite_tpu.cli import rating_based_ranking
        rc = rating_based_ranking.main([
            "--training-file", TRAIN, "--test-file", TEST,
            "--recommender", "UserItemBaseline", "--random-seed", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "AUC" in out and "prec@5" in out

    def test_cross_validation_without_test_file(self, example_files, capsys):
        TRAIN, TEST = example_files
        from mymedialite_tpu.cli import rating_based_ranking
        rc = rating_based_ranking.main([
            "--training-file", TRAIN, "--recommender", "UserItemBaseline",
            "--cross-validation", "2", "--random-seed", "1"])
        assert rc == 0
        assert "AUC" in capsys.readouterr().out

    def test_cv_find_iter_rejected(self, example_files, capsys):
        TRAIN, TEST = example_files
        # reference RatingBasedRanking.CheckParameters :64-65
        from mymedialite_tpu.cli import rating_based_ranking
        with pytest.raises(SystemExit):
            rating_based_ranking.main([
                "--training-file", TRAIN, "--recommender",
                "MatrixFactorization", "--cross-validation", "2",
                "--find-iter", "1"])
        err = capsys.readouterr().err
        assert "not supported for rating-based ranking" in err
