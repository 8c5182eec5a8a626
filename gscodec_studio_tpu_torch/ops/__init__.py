"""Splat ops: projection, SH, the fused tile rasterizer (raster_v2), the
legacy v1 tile rasterizer (rasterize_pallas) and its binning (isect)."""
