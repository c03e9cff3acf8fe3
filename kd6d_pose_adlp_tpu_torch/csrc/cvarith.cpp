// cv2's uint8 colour, filter and resize arithmetic of the train-time
// augmentations, bit-equal to what OpenCV's dispatched (AVX2) code returns
// for the calls the JAX package makes (kd6d_pose_adlp_tpu/data/transforms.py):
//
//   bgr2hsv_u8        cvtColor(COLOR_BGR2HSV): integer tables, hsv_shift 12,
//                     H in [0, 180)
//   hsv2bgr_u8        cvtColor(COLOR_HSV2BGR): float32 sector arithmetic; the
//                     vector loop (32 pixels a step) fuses v * (1 - s * h)
//                     into an FMA and truncates, the scalar tail of a row
//                     fuses the same way and rounds
//   gaussian_blur7_u8 GaussianBlur((7, 7), sigma): the bit-exact fixed-point
//                     kernel (8 fraction bits, error-diffused rounding, the
//                     small-kernel table at sigma <= 0), BORDER_REFLECT_101
//   box_blur_u8       blur((k, k)): window sums and the 8U fixed-point
//                     division ((s + delta) * scale >> 23), BORDER_REFLECT_101
//   normalize_minmax  normalize(NORM_MINMAX) of float32 / float64 over all
//                     channels: convertTo's fused src * scale + shift, scale 0
//                     when max == min
//   resize_linear_u8  resize(INTER_LINEAR): 11-bit coefficients, int row
//                     sums, the vertical pass as the vector code does it
//                     (rows >> 4, 16-bit high products, rounding >> 2)
//
// FMAs are explicit (std::fma) and the library is built with
// -ffp-contract=off, so no other multiply-add is fused.
// Compiled with dataplane.cpp into one library by data/native.py.
#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

// cv::borderInterpolate for BORDER_REFLECT_101
inline int reflect101(int p, int len) {
  if (len == 1) return 0;
  while ((unsigned)p >= (unsigned)len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

inline uint8_t sat_u8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

struct HsvTables {
  int sdiv[256], hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = (int)std::nearbyint((255 << 12) / (1. * i));
      hdiv[i] = (int)std::nearbyint((180 << 12) / (6. * i));
    }
  }
} g_hsv;

// the (h, s, v) -> (b, g, r) arithmetic of a pixel in float32; `vec` picks
// the vector loop's sector split and truncation over the scalar tail's
// fmod / floor and rounding
inline void hsv_pixel(const uint8_t* p, uint8_t* o, bool vec) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.f / 180.f;
  float h = (float)p[0], s = p[1] * (1.f / 255.f), v = p[2] * (1.f / 255.f);
  float tab[4];
  int sector;
  h *= hscale;
  if (vec) {
    float pre = std::trunc(h);
    h -= pre;
    sector = (int)(pre - std::trunc(pre * (1.f / 6.f)) * 6.f);
  } else {
    if (s == 0.f) {
      int c = (int)std::nearbyint(v * 255.f);
      o[0] = o[1] = o[2] = sat_u8(c);
      return;
    }
    h = std::fmod(h, 6.f);
    sector = (int)std::floor(h);
    h -= (float)sector;
    if ((unsigned)sector >= 6u) {
      sector = 0;
      h = 0.f;
    }
  }
  tab[0] = v;
  tab[1] = v * (1.f - s);
  tab[2] = v * std::fma(-s, h, 1.f);
  tab[3] = v * std::fma(-s, 1.f - h, 1.f);
  for (int k = 0; k < 3; ++k) {
    float x = tab[sector_data[sector][k]] * 255.f;
    o[k] = sat_u8(vec ? (int)x : (int)std::nearbyint(x));
  }
}

// cv::getGaussianKernelBitExact + getGaussianKernelFixedPoint_ED at 8
// fraction bits, for ksize 7
void gaussian_kernel7(double sigma, int* k) {
  const int n = 7, n2 = 3;
  if (sigma <= 0) {
    static const int tab[7] = {8, 28, 56, 72, 56, 28, 8};   // 1/32, 7/64, 7/32, 9/32
    std::memcpy(k, tab, sizeof(tab));
    return;
  }
  double scale2x = -0.125 / (sigma * sigma);
  double values[n2], sum = 0;
  for (int i = 0, x = 1 - n; i < n2; ++i, x += 2) {
    values[i] = std::exp((double)(x * x) * scale2x);
    sum += values[i];
  }
  sum *= 2;
  sum += 1.0;
  double mul1 = 1.0 / sum, err = 0;
  int64_t total = 0;
  for (int i = 0; i < n2; ++i) {
    double adj = values[i] * mul1 * 256.0 + err;
    int64_t v0 = (int64_t)std::nearbyint(adj);
    err = adj - (double)v0;
    k[i] = k[n - 1 - i] = (int)v0;
    total += v0;
  }
  k[n2] = (int)(256 - 2 * total);
}

}  // namespace

extern "C" {

void bgr2hsv_u8(const uint8_t* src, int64_t npix, uint8_t* dst) {
  for (int64_t i = 0; i < npix; ++i, src += 3, dst += 3) {
    int b = src[0], g = src[1], r = src[2];
    int v = std::max(std::max(b, g), r), vmin = std::min(std::min(b, g), r);
    int diff = v - vmin;
    int vr = v == r ? -1 : 0, vg = v == g ? -1 : 0;
    int s = (diff * g_hsv.sdiv[v] + (1 << 11)) >> 12;
    int h = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff)) + ((~vg) & (r - g + 4 * diff))));
    h = (h * g_hsv.hdiv[diff] + (1 << 11)) >> 12;
    h += h < 0 ? 180 : 0;
    dst[0] = sat_u8(h);
    dst[1] = (uint8_t)s;
    dst[2] = (uint8_t)v;
  }
}

void hsv2bgr_u8(const uint8_t* src, int h, int w, uint8_t* dst) {
  const int nvec = (w / 32) * 32;     // cvtColor runs row by row
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + (size_t)y * w * 3;
    uint8_t* o = dst + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      uint8_t bgr[3];
      hsv_pixel(s + 3 * x, bgr, x < nvec);
      o[3 * x] = bgr[0];
      o[3 * x + 1] = bgr[1];
      o[3 * x + 2] = bgr[2];
    }
  }
}

void gaussian_blur7_u8(const uint8_t* src, int h, int w, int cn, double sigma, uint8_t* dst) {
  int k7[7], one[1] = {256};
  gaussian_kernel7(sigma, k7);
  // GaussianBlur drops the kernel along a dimension of size 1
  const int* kx = w == 1 ? one : k7;
  const int* ky = h == 1 ? one : k7;
  const int nx = w == 1 ? 1 : 7, ny = h == 1 ? 1 : 7;
  if (nx == 1 && ny == 1) {
    std::memcpy(dst, src, (size_t)h * w * cn);
    return;
  }
  const int rowlen = w * cn, ax = nx / 2;
  std::vector<uint16_t> hb((size_t)h * rowlen);
  std::vector<uint8_t> pad((size_t)(w + 2 * ax) * cn);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + (size_t)y * rowlen;
    for (int x = -ax; x < w + ax; ++x)
      std::memcpy(pad.data() + (size_t)(x + ax) * cn, s + (size_t)reflect101(x, w) * cn, cn);
    uint16_t* o = hb.data() + (size_t)y * rowlen;
    for (int i = 0; i < rowlen; ++i) o[i] = 0;
    for (int j = 0; j < nx; ++j) {
      const uint8_t* p = pad.data() + (size_t)j * cn;
      const uint16_t kk = (uint16_t)kx[j];
      for (int i = 0; i < rowlen; ++i) o[i] = (uint16_t)(o[i] + kk * p[i]);
    }
  }
  std::vector<uint32_t> acc(rowlen);
  for (int y = 0; y < h; ++y) {
    std::fill(acc.begin(), acc.end(), 0u);
    for (int i = 0; i < ny; ++i) {
      const uint16_t* r = hb.data() + (size_t)reflect101(y + i - ny / 2, h) * rowlen;
      const uint32_t kk = (uint32_t)ky[i];
      for (int x = 0; x < rowlen; ++x) acc[x] += kk * r[x];
    }
    uint8_t* o = dst + (size_t)y * rowlen;
    for (int x = 0; x < rowlen; ++x) o[x] = sat_u8((int)((acc[x] + (1u << 15)) >> 16));
  }
}

void box_blur_u8(const uint8_t* src, int h, int w, int cn, int ksize, uint8_t* dst) {
  // ColumnSum<ushort, uchar>: d = ksize^2 <= 256
  const int d = ksize * ksize, a = ksize / 2;
  const double scalef0 = (double)(1 << 23) / d;
  int ds = (int)std::floor(scalef0), dd = d / 2;
  if (scalef0 - ds < 0.5)
    ++dd;
  else
    ++ds;
  const int rowlen = w * cn;
  std::vector<uint32_t> hs((size_t)h * rowlen);
  std::vector<uint8_t> pad((size_t)(w + 2 * a) * cn);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + (size_t)y * rowlen;
    for (int x = -a; x < w + a; ++x)
      std::memcpy(pad.data() + (size_t)(x + a) * cn, s + (size_t)reflect101(x, w) * cn, cn);
    uint32_t* o = hs.data() + (size_t)y * rowlen;
    for (int c = 0; c < cn; ++c) {           // sliding window sums along the row
      uint32_t acc = 0;
      for (int j = 0; j < ksize; ++j) acc += pad[(size_t)j * cn + c];
      o[c] = acc;
      for (int x = 1; x < w; ++x) {
        acc += pad[(size_t)(x + ksize - 1) * cn + c];
        acc -= pad[(size_t)(x - 1) * cn + c];
        o[(size_t)x * cn + c] = acc;
      }
    }
  }
  std::vector<uint32_t> acc(rowlen, 0u);
  for (int i = -a; i <= a; ++i) {
    const uint32_t* r = hs.data() + (size_t)reflect101(i, h) * rowlen;
    for (int x = 0; x < rowlen; ++x) acc[x] += r[x];
  }
  for (int y = 0; y < h; ++y) {               // sliding window sums down the columns
    if (y > 0) {
      const uint32_t* add = hs.data() + (size_t)reflect101(y + a, h) * rowlen;
      const uint32_t* sub = hs.data() + (size_t)reflect101(y - a - 1, h) * rowlen;
      for (int x = 0; x < rowlen; ++x) acc[x] = acc[x] + add[x] - sub[x];
    }
    uint8_t* o = dst + (size_t)y * rowlen;
    for (int x = 0; x < rowlen; ++x)
      o[x] = (uint8_t)(((int64_t)(acc[x] + dd) * ds) >> 23);
  }
}

// cv::normalize(NORM_MINMAX) to [0, 255]: scale 0 when max - min is within
// DBL_EPSILON; in float32 the scale and the shift are rounded to float first
void normalize_minmax_f32(const float* src, int64_t n, float* dst) {
  float smin = src[0], smax = src[0];
  for (int64_t i = 1; i < n; ++i) {
    smin = std::min(smin, src[i]);
    smax = std::max(smax, src[i]);
  }
  double range = (double)smax - (double)smin;
  float scale = (float)(255.0 * (range > 2.220446049250313e-16 ? 1. / range : 0));
  float shift = 0.f - (float)((double)smin * (double)scale);
  for (int64_t i = 0; i < n; ++i) dst[i] = std::fma(src[i], scale, shift);
}

void normalize_minmax_f64(const double* src, int64_t n, double* dst) {
  double smin = src[0], smax = src[0];
  for (int64_t i = 1; i < n; ++i) {
    smin = std::min(smin, src[i]);
    smax = std::max(smax, src[i]);
  }
  double scale = 255.0 * (smax - smin > 2.220446049250313e-16 ? 1. / (smax - smin) : 0);
  double shift = 0.0 - smin * scale;
  for (int64_t i = 0; i < n; ++i) dst[i] = std::fma(src[i], scale, shift);
}

void resize_linear_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw) {
  const double scale_x = 1. / ((double)dw / sw), scale_y = 1. / ((double)dh / sh);
  std::vector<int> xofs(dw), yofs(dh);
  std::vector<int16_t> xa(2 * (size_t)dw), yb(2 * (size_t)dh);
  for (int dx = 0; dx < dw; ++dx) {
    float fx = (float)((dx + 0.5) * scale_x - 0.5);
    int sx = (int)std::floor(fx);
    fx -= (float)sx;
    if (sx < 0) fx = 0.f, sx = 0;
    if (sx >= sw - 1) fx = 0.f, sx = sw - 1;
    xofs[dx] = sx;
    xa[2 * dx] = (int16_t)std::nearbyint((1.f - fx) * 2048.f);
    xa[2 * dx + 1] = (int16_t)std::nearbyint(fx * 2048.f);
  }
  for (int dy = 0; dy < dh; ++dy) {
    float fy = (float)((dy + 0.5) * scale_y - 0.5);
    int sy = (int)std::floor(fy);
    fy -= (float)sy;
    yofs[dy] = sy;
    yb[2 * dy] = (int16_t)std::nearbyint((1.f - fy) * 2048.f);
    yb[2 * dy + 1] = (int16_t)std::nearbyint(fy * 2048.f);
  }
  const int rowlen = dw * cn;
  // horizontal pass of every source row a destination row reads
  std::vector<int32_t> hrow((size_t)sh * rowlen);
  std::vector<char> done(sh, 0);
  auto hpass = [&](int r) {
    if (done[r]) return;
    done[r] = 1;
    const uint8_t* s = src + (size_t)r * sw * cn;
    int32_t* o = hrow.data() + (size_t)r * rowlen;
    for (int dx = 0; dx < dw; ++dx) {
      int sx = xofs[dx], sx1 = std::min(sx + 1, sw - 1);
      for (int c = 0; c < cn; ++c)
        o[dx * cn + c] = s[sx * cn + c] * xa[2 * dx] + s[sx1 * cn + c] * xa[2 * dx + 1];
    }
  };
  auto mulhi = [](int32_t a, int32_t b) { return (a * b) >> 16; };
  for (int dy = 0; dy < dh; ++dy) {
    int r0 = std::min(std::max(yofs[dy], 0), sh - 1), r1 = std::min(std::max(yofs[dy] + 1, 0), sh - 1);
    hpass(r0);
    hpass(r1);
    const int32_t* s0 = hrow.data() + (size_t)r0 * rowlen;
    const int32_t* s1 = hrow.data() + (size_t)r1 * rowlen;
    const int32_t b0 = yb[2 * dy], b1 = yb[2 * dy + 1];
    uint8_t* o = dst + (size_t)dy * rowlen;
    for (int x = 0; x < rowlen; ++x) {
      int32_t a0 = std::min(s0[x] >> 4, 32767), a1 = std::min(s1[x] >> 4, 32767);
      o[x] = sat_u8((mulhi(a0, b0) + mulhi(a1, b1) + 2) >> 2);
    }
  }
}

}  // extern "C"
