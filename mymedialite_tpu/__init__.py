"""mymedialite_tpu — a collaborative-filtering framework on JAX.

A from-scratch rebuild of the capabilities of MyMediaLite
(reference: jordansilva/MyMediaLite, C#/Mono) as array programs:

- interaction data as packed int32/float32 COO + CSR arrays (not object lists)
- all hot math as XLA-compiled JAX (minibatch SGD scatter-adds, batched ALS
  solves, full-catalog top-K matmuls, co-occurrence Gram matmuls)
- multi-device scaling via jax.sharding.Mesh + row-sharded embedding tables
  (the replacement for the reference's Gemulla DSGD multicore scheduler,
  reference MultiCore.cs:43-92)

Two task families, mirroring the reference:
- rating prediction (explicit feedback; RMSE/MAE/NMAE/CBD)
- item recommendation (positive-only feedback; AUC/prec@N/recall@N/MAP/NDCG/MRR)
"""

__version__ = "0.1.0"

from mymedialite_tpu.models.registry import (  # noqa: F401
    create_rating_predictor,
    create_item_recommender,
    list_rating_predictors,
    list_item_recommenders,
)
