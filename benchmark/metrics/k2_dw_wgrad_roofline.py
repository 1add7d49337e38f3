"""Roofline share of kernels/k2_dw_wgrad.json's kernels (benchmark.lib.readers)."""

from benchmark.lib.readers import roofline


def read(run):
    return roofline(run, "k2_dw_wgrad")
