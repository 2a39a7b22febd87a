"""Percent of the window in which no operation ran on the card: the
traced slice's device-busy seconds a model FLOP, times the window's FLOPs,
over the window's seconds (lib/readings.py::window_idle_share)."""

from benchmark.lib.readings import window_idle_share


def read(ctx):
    return window_idle_share(ctx)
