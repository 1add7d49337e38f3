"""Roofline share of kernels/k45_attn_bwd.json's kernels (benchmark.lib.readers)."""

from benchmark.lib.readers import roofline


def read(run):
    return roofline(run, "k45_attn_bwd")
