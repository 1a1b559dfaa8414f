"""anime_recommendations_tpu — a JAX/XLA recommender engine for one or more GPUs.

A from-scratch rebuild of the capabilities of Dyrutter/anime_recommendations:
the MLflow/W&B pipeline of 8 scripts becomes a single sharded engine with a
typed config, a pure-JAX two-tower embedding model, retrieval ops written in
plain jax.numpy/lax that XLA compiles for the device, and a local versioned
artifact store.

Layer map (mirrors SURVEY.md §7 build plan):
  config      — one typed config (replaces hydra YAML + MLproject strings + argparse)
  data        — ingest / preprocess / vocab / dataset iterators / catalog
  models      — pure-JAX two-tower dot-product model
  ops         — masked top-k (f32/bf16/int8), IVF, rating scoring, sparse Adam
  train       — jitted training loop, LR schedule, checkpointing, early stopping
  parallel    — mesh/sharding layer: row-sharded embedding tables, psum-routed lookups
  recommend   — similar_anime / similar_users / user_prefs / user_recs / model_recs
  pipeline    — artifact store + step runner (replaces MLflow/W&B round-trips)
  serve       — in-process + HTTP query surface (the API layer the reference planned)
"""

__version__ = "0.1.0"
