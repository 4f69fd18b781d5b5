"""Training-side utilities the serving path needs (checkpoints)."""
