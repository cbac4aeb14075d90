"""Data pipeline: OptaGen channel maps, synthetic dumps, preprocessing,
the on-disk cache, the full-frame tiler and the corpus staged on the card."""
