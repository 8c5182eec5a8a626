"""Splat ops: projection, SH, and the fused tile rasterizer (raster_v2)."""
