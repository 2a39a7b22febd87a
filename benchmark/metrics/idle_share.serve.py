"""Percent of the traced slice's window in which no operation ran on the
card: 1 - busy / window, from the profiler's device events."""

from benchmark.lib.readings import idle_share


def read(ctx):
    return idle_share(ctx)
