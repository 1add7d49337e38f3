"""Model FLOPs utilisation of the window (benchmark.lib.readers.mfu)."""

from benchmark.lib.readers import mfu


def read(run):
    return mfu(run)
