"""Fold-in evaluation, Nelder-Mead search, rating_based_ranking CLI."""

import numpy as np
import pytest

from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.eval.foldin import (
    evaluate_fold_in, evaluate_fold_in_complete_retraining,
    evaluate_fold_in_incremental_training,
)
from mymedialite_tpu.models.registry import create_rating_predictor


@pytest.fixture(scope="module")
def foldin_data():
    data = synthetic_ratings(num_ratings=8000, num_users=200, num_items=250,
                             seed=31)
    train, rest = split_ratings(data, test_fraction=0.3, seed=32)
    update, eval_ = split_ratings(rest, test_fraction=0.5, seed=33)
    return train, update, eval_


class TestFoldIn:
    def test_true_fold_in(self, foldin_data):
        train, update, eval_ = foldin_data
        m = create_rating_predictor("BiasedMatrixFactorization")
        m.ratings = train
        m.num_iter = 5
        m.batch_size = 4096
        m.train()
        res = evaluate_fold_in(m, update, eval_)
        assert np.isfinite(res["RMSE"])
        assert 0 < res["RMSE"] < 3

    def test_incremental_fold_in(self, foldin_data):
        train, update, eval_ = foldin_data
        m = create_rating_predictor("UserItemBaseline")
        m.ratings = train
        m.train()
        res = evaluate_fold_in_incremental_training(m, update, eval_)
        assert np.isfinite(res["RMSE"])

    def test_complete_retraining_fold_in(self, foldin_data):
        train, update, eval_ = foldin_data
        m = create_rating_predictor("GlobalAverage")
        m.ratings = train
        m.train()
        res = evaluate_fold_in_complete_retraining(m, update, eval_)
        assert np.isfinite(res["RMSE"])


class TestNelderMead:
    def test_finds_good_reg(self):
        from mymedialite_tpu import hyperopt
        data = synthetic_ratings(num_ratings=5000, num_users=150,
                                 num_items=200, seed=41)
        m = create_rating_predictor("UserItemBaseline")
        m.ratings = data
        hyperopt.NUM_IT, saved = 5, hyperopt.NUM_IT  # keep the test fast
        try:
            nm = hyperopt.NelderMead("RMSE", m)
            best = nm.find_minimum()
        finally:
            hyperopt.NUM_IT = saved
        assert np.isfinite(best)
        assert m.reg_u >= 0 and m.reg_i >= 0

    def test_unsupported_model(self):
        from mymedialite_tpu.hyperopt import NelderMead
        m = create_rating_predictor("GlobalAverage")
        m.ratings = synthetic_ratings(num_ratings=100, num_users=20,
                                      num_items=20)
        with pytest.raises(ValueError):
            NelderMead("RMSE", m)


class TestRatingBasedRankingCLI:
    def test_end_to_end(self, example_files, capsys):
        from mymedialite_tpu.cli import rating_based_ranking as rbr
        train, test = example_files
        rc = rbr.main([
            "--training-file", train, "--test-file", test,
            "--recommender", "UserItemBaseline"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "AUC" in out and "prec@5" in out
