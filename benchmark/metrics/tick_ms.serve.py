"""Window ms per decode tick of the engine (benchmark.lib.readers)."""

from benchmark.lib.readers import tick_ms


def read(run):
    return tick_ms(run)
