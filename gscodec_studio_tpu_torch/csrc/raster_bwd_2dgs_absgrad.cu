// B6, the 2DGS tile backward (raster_bwd_2dgs.cuh), with the absgrad rows:
// their instantiations, built beside raster_bwd_2dgs.cu's.

#include "raster_bwd_2dgs.cuh"

int gsc::raster_bwd_2dgs_absgrad(const void* S, long long cap,
                                 const void* starts, const void* masks,
                                 const void* tiles, const void* v_tiles,
                                 int n_tiles, int tile_width, int tile_height,
                                 int tile_size, int cb, int zch, int soft,
                                 int log_composite, void* out, void* stream) {
  return run<true>(S, cap, starts, masks, tiles, v_tiles, n_tiles,
                   tile_width, tile_height, tile_size, cb, zch, soft,
                   log_composite, out, stream);
}
