"""Recommenders that serve pre-computed predictions from a file.

JAX counterparts of reference
``RatingPrediction/ExternalRatingPredictor.cs:32`` and
``ItemRecommendation/ExternalItemRecommender.cs:32``: 'training' reads a
``user item score`` file through the program's ID mappings and serves
lookups from it.
"""

from __future__ import annotations

import numpy as np

from mymedialite_tpu.models.base import ItemRecommender, RatingPredictor


class _ExternalScores:
    HYPERPARAMS = {"prediction_file": str}

    def __init__(self):
        self.prediction_file = "FILENAME"
        self.user_mapping = None
        self.item_mapping = None
        self._scores = {}
        self._default = 0.0

    def _read(self):
        from mymedialite_tpu.data.io import read_rating_data
        data = read_rating_data(self.prediction_file, self.user_mapping,
                                self.item_mapping, use_cache=False)
        self._scores = {}
        for u, i, v in zip(data.users, data.items, data.values):
            self._scores[(int(u), int(i))] = float(v)
        self.num_users_trained = data.num_users
        self.num_items_trained = data.num_items

    def can_predict(self, user_id, item_id):
        return (user_id, item_id) in self._scores

    def predict_batch(self, users, items):
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        return np.array([self._scores.get((int(u), int(i)), self._default)
                         for u, i in zip(users, items)], dtype=np.float32)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class ExternalRatingPredictor(_ExternalScores, RatingPredictor):
    def __init__(self):
        RatingPredictor.__init__(self)
        _ExternalScores.__init__(self)

    def train(self):
        self._read()


class ExternalItemRecommender(_ExternalScores, ItemRecommender):
    def __init__(self):
        ItemRecommender.__init__(self)
        _ExternalScores.__init__(self)
        self._default = -3.4e38

    def train(self):
        self._read()
