"""Training in the port: the train step, AdamW, the data pipeline, checkpoints and elastic bookkeeping."""
