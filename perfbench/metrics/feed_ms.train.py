"""Host milliseconds a traced training step spends in the chunk feed
(``loans.feed`` spans, waits included): the time the loop stands in
``data/device_data.py::device_chunk_batches``."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, {"loans.feed"}, "steps")
