// Which pixel of a tile each blend thread takes, and the pixel-centre
// rectangle of its warp (csrc/blend.cu, csrc/blend_backward.cu; the plain
// PyTorch version is ops/blend.py::_warp_layout).
//
// When tile_w % 8 == 0 and tile_h % 4 == 0 a warp takes an 8x4 block of
// pixels (lane l: column l % 8, row l / 8 of the block), the blocks in
// row-major order. A compact block meets fewer splats than a row of 32
// pixels, so the per-warp cull keeps fewer keys for it (PERF.md).
// Otherwise thread i takes pixel i in row-major order, and a warp's
// rectangle covers whole rows when it spans rows.
#pragma once

struct WarpPixels {
  int pixel;              // row-major index of the thread's pixel
  float x, y;             // its pixel centre
  float x0, x1, y0, y1;   // the warp's rectangle of pixel centres
};

__device__ __forceinline__ WarpPixels warp_pixels(int tid, int npx,
                                                  int tile_w, int tile_h) {
  const int warp = tid / 32, lane = tid % 32;
  int c0, c1, r0, r1, px, py;
  if (tile_w % 8 == 0 && tile_h % 4 == 0) {
    const int bx = warp % (tile_w / 8), by = warp / (tile_w / 8);
    c0 = bx * 8;
    c1 = c0 + 7;
    r0 = by * 4;
    r1 = r0 + 3;
    px = c0 + lane % 8;
    py = r0 + lane / 8;
  } else {
    const int p0 = warp * 32, p1 = min(p0 + 31, npx - 1);
    r0 = p0 / tile_w;
    r1 = p1 / tile_w;
    c0 = r0 == r1 ? p0 % tile_w : 0;
    c1 = r0 == r1 ? p1 % tile_w : tile_w - 1;
    px = tid % tile_w;
    py = tid / tile_w;
  }
  return {py * tile_w + px,         (float)px + 0.5f, (float)py + 0.5f,
          (float)c0 + 0.5f,         (float)c1 + 0.5f, (float)r0 + 0.5f,
          (float)r1 + 0.5f};
}
