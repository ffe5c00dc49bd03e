"""Overlapped tiling: plan, extract, crop-stitch."""
