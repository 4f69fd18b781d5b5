"""Device-resident training data (counterpart of ``loans_tpu.data``)."""
