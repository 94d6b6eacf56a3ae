"""Sketch model families: mash (bottom-k), scaled, allcounts.

Mirrors the reference's sketch schemes
(finch-rs/lib/src/sketch_schemes/) re-designed as batched,
device-friendly reductions instead of streaming heaps.
"""
