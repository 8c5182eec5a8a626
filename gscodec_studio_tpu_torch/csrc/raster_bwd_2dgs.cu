// B6, the 2DGS tile backward (raster_bwd_2dgs.cuh): the C entry, and the
// instantiations without the absgrad rows. Those with them are built apart,
// in raster_bwd_2dgs_absgrad.cu.

#include "raster_bwd_2dgs.cuh"

extern "C" int gsc_raster_bwd_2dgs(const void* S, long long cap,
                                   const void* starts, const void* masks,
                                   const void* tiles, const void* v_tiles,
                                   int n_tiles, int tile_width,
                                   int tile_height, int tile_size, int cb,
                                   int zch, int soft, int absgrad,
                                   int log_composite, void* out,
                                   void* stream) {
  if (absgrad) {
    return gsc::raster_bwd_2dgs_absgrad(
        S, cap, starts, masks, tiles, v_tiles, n_tiles, tile_width,
        tile_height, tile_size, cb, zch, soft, log_composite, out, stream);
  }
  return run<false>(S, cap, starts, masks, tiles, v_tiles, n_tiles,
                    tile_width, tile_height, tile_size, cb, zch, soft,
                    log_composite, out, stream);
}
