"""Data pipeline: OptaGen channel maps, synthetic dumps, preprocessing,
the on-disk cache and the full-frame tiler."""
