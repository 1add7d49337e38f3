"""Roofline share of kernels/k1_dw_fwd.json's kernels (benchmark.lib.readers)."""

from benchmark.lib.readers import roofline


def read(run):
    return roofline(run, "k1_dw_fwd")
