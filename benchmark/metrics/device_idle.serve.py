"""The card's idle share of the traced stretch (benchmark.lib.readers)."""

from benchmark.lib.readers import device_idle


def read(run):
    return device_idle(run)
