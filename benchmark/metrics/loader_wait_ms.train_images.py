"""Host ms per step in the loader's next() (benchmark.lib.readers)."""

from benchmark.lib.readers import loader_wait_ms


def read(run):
    return loader_wait_ms(run)
