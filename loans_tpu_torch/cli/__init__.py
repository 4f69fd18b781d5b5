"""Command-line entry points (counterpart of ``loans_tpu.cli``)."""
