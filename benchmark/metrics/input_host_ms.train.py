"""input_host_ms.train: host ms a step inside the loader.wait (the wait for
the loader's threads) and prefetch.put (pinning a batch, enqueueing its
copies) spans, from the traced slice (lib/span_split.py)."""

from benchmark.lib.span_split import host_ms


def read(ctx):
    return host_ms(ctx, "loader.wait", "prefetch.put")
