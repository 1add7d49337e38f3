"""Roofline share of kernels/k3_attn_fwd.json's kernels (benchmark.lib.readers)."""

from benchmark.lib.readers import roofline


def read(run):
    return roofline(run, "k3_attn_fwd")
