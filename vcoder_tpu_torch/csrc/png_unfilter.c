/* Undo the scanline filters of an 8-bit PNG (PNG specification, section 9):
 * the row loop of ``vcoder_tpu_torch/png.py``'s decoder, in C because the
 * Average and Paeth filters run byte by byte. Host code, built with ``cc``
 * and loaded with ctypes; ctypes drops the GIL for the call. */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

/* ``raw`` holds ``height`` rows of one filter byte and ``stride`` filtered
 * bytes; ``out`` gets ``height`` x ``stride`` unfiltered bytes. ``bpp`` is
 * the bytes per pixel. Returns 0, or 1 + the first row whose filter type is
 * unknown. */
int png_unfilter(const uint8_t *raw, uint8_t *out, int height, int stride, int bpp) {
  for (int y = 0; y < height; ++y) {
    const uint8_t *in = raw + (size_t)y * (stride + 1) + 1;
    uint8_t *cur = out + (size_t)y * stride;
    const uint8_t *prev = y ? cur - stride : NULL;
    switch (in[-1]) {
      case 0:
        memcpy(cur, in, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i) cur[i] = in[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:
        for (int i = 0; i < stride; ++i) cur[i] = in[i] + (prev ? prev[i] : 0);
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = in[i] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = prev && i >= bpp ? prev[i - bpp] : 0;
          cur[i] = in[i] + paeth(a, b, c);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
