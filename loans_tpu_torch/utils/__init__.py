"""Framework helpers (counterpart of ``loans_tpu.utils``)."""
