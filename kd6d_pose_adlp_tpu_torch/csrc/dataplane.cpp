// Host data plane of the port's BOP pipeline (a copy of the JAX package's
// native/dataplane.cpp, its three functions unchanged in arithmetic, plus
// png_unfilter).
//
// The hot per-sample host work (reference: two cv2.warpAffine calls + HSV /
// normalize per item, libs/transform.py + libs/dzi_libs.py) implemented as a
// small dependency-free C++ library: inverse-mapped bilinear/nearest affine
// warps, a fused BGR-u8 -> normalized-RGB-f32 conversion and the PNG row
// filters' inverse (data/png.py inflates IDAT with zlib, this undoes the
// filters). Bound from Python via ctypes (data/native.py). The warps are
// row-partitioned across a caller-chosen number of std::threads.
//
// Built at first use by data/native.py into kd6d_pose_adlp_tpu_torch/_build/:
//   g++ -O3 -shared -fPIC dataplane.cpp -o libdataplane-<hash>.so -lpthread
#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

struct Affine {
  // dst -> src mapping (inverse of the user-supplied src -> dst matrix)
  double a, b, c, d, e, f;
};

Affine invert(const double* M) {
  // M is 2x3 row-major src->dst
  double det = M[0] * M[4] - M[1] * M[3];
  if (std::abs(det) < 1e-12) det = det < 0 ? -1e-12 : 1e-12;
  Affine inv;
  inv.a = M[4] / det;
  inv.b = -M[1] / det;
  inv.d = -M[3] / det;
  inv.e = M[0] / det;
  inv.c = -(inv.a * M[2] + inv.b * M[5]);
  inv.f = -(inv.d * M[2] + inv.e * M[5]);
  return inv;
}

template <typename Fn>
void parallel_rows(int rows, int n_threads, Fn&& fn) {
  if (n_threads <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  int chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int y0 = t * chunk, y1 = std::min(rows, y0 + chunk);
    if (y0 >= y1) break;
    ts.emplace_back([=, &fn] { fn(y0, y1); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Bilinear warp of an interleaved uint8 image (C channels).
// M: 2x3 row-major src->dst affine. border: per-channel fill value.
//
// Fixed-point (10 fractional bits) with per-row incremental source
// coordinates and a boundary-check-free interior span per row (the
// bilinear footprint provably inside the source); edge pixels take the
// checked path. Matches cv2.warpAffine INTER_LINEAR to within 1 LSB
// (cv2 uses 5-bit interpolation tables; we keep all 10 bits).
void warp_affine_u8(const uint8_t* src, int sh, int sw, int ch,
                    uint8_t* dst, int dh, int dw,
                    const double* M, const uint8_t* border, int n_threads) {
  constexpr int FB = 10;
  constexpr int64_t ONE = 1 << FB;
  constexpr int64_t HALF2 = (int64_t)1 << (2 * FB - 1);  // rounding bias
  Affine inv = invert(M);
  const size_t sstride = (size_t)sw * ch;

  // exact per-x deltas (no incremental error accumulation): cx(x, y) =
  // rowbase(y) + adelta[x], each term rounded once -> |err| <= 2^-FB px
  std::vector<int64_t> adelta(dw), ddelta(dw);
  for (int x = 0; x < dw; ++x) {
    adelta[x] = (int64_t)std::llround(inv.a * x * ONE);
    ddelta[x] = (int64_t)std::llround(inv.d * x * ONE);
  }

  parallel_rows(dh, n_threads, [&](int yy0, int yy1) {
    for (int y = yy0; y < yy1; ++y) {
      const int64_t bx = (int64_t)std::llround((inv.b * y + inv.c) * ONE);
      const int64_t by = (int64_t)std::llround((inv.e * y + inv.f) * ONE);
      uint8_t* out = dst + (size_t)y * dw * ch;

      const auto inside = [&](int xq) {
        const int x0 = (int)((bx + adelta[xq]) >> FB);
        const int y0i = (int)((by + ddelta[xq]) >> FB);
        return x0 >= 0 && y0i >= 0 && x0 + 1 < sw && y0i + 1 < sh;
      };
      // interior span [lo, hi): solve the linear bounds along the row in
      // double, then verify/shrink the endpoints in exact fixed point
      const auto span1 = [&](double v0, double dv, int lim) {
        double lo = 0, hi = dw;
        const double vmax = (double)(lim - 1) - 1.0 / ONE;
        if (dv > 1e-12) {
          lo = std::max(lo, -v0 / dv);
          hi = std::min(hi, (vmax - v0) / dv + 1);
        } else if (dv < -1e-12) {
          lo = std::max(lo, (vmax - v0) / dv);
          hi = std::min(hi, -v0 / dv + 1);
        } else if (v0 < 0 || v0 > vmax) {
          return std::pair<int, int>(0, 0);
        }
        int a = (int)std::ceil(std::max(0.0, lo));
        int b = (int)std::floor(std::min((double)dw, hi));
        return std::pair<int, int>(a, std::max(a, b));
      };
      auto sx_span = span1(inv.b * y + inv.c, inv.a, sw);
      auto sy_span = span1(inv.e * y + inv.f, inv.d, sh);
      int lo = std::max(sx_span.first, sy_span.first);
      int hi = std::min(sx_span.second, sy_span.second);
      if (lo > hi) lo = hi = 0;
      while (lo < hi && !inside(lo)) ++lo;
      while (hi > lo && !inside(hi - 1)) --hi;

      const auto checked = [&](int x) {
        const int64_t cx = bx + adelta[x], cy = by + ddelta[x];
        const int x0 = (int)(cx >> FB), y0i = (int)(cy >> FB);
        uint8_t* o = out + (size_t)x * ch;
        if (x0 < -1 || y0i < -1 || x0 >= sw || y0i >= sh) {
          std::memcpy(o, border, ch);
          return;
        }
        const int fx = (int)(cx & (ONE - 1)), fy = (int)(cy & (ONE - 1));
        const int x1 = x0 + 1, y1i = y0i + 1;
        for (int c = 0; c < ch; ++c) {
          const auto px = [&](int yr, int xr) -> int {
            if (xr < 0 || yr < 0 || xr >= sw || yr >= sh) return border[c];
            return src[(size_t)yr * sstride + (size_t)xr * ch + c];
          };
          int64_t t = (int64_t)(px(y0i, x0) * (ONE - fx) + px(y0i, x1) * fx)
                          * (ONE - fy) +
                      (int64_t)(px(y1i, x0) * (ONE - fx) + px(y1i, x1) * fx)
                          * fy;
          o[c] = (uint8_t)((t + HALF2) >> (2 * FB));
        }
      };

      int x = 0;
      for (; x < lo; ++x) checked(x);
      if (ch == 3) {
        for (; x < hi; ++x) {
          const int64_t cx = bx + adelta[x], cy = by + ddelta[x];
          const int x0 = (int)(cx >> FB), y0i = (int)(cy >> FB);
          const int fx = (int)(cx & (ONE - 1)), fy = (int)(cy & (ONE - 1));
          const uint8_t* p0 = src + (size_t)y0i * sstride + (size_t)x0 * 3;
          const uint8_t* p1 = p0 + sstride;
          uint8_t* o = out + (size_t)x * 3;
          for (int c = 0; c < 3; ++c) {
            int64_t t = (int64_t)(p0[c] * (ONE - fx) + p0[3 + c] * fx)
                            * (ONE - fy) +
                        (int64_t)(p1[c] * (ONE - fx) + p1[3 + c] * fx) * fy;
            o[c] = (uint8_t)((t + HALF2) >> (2 * FB));
          }
        }
      } else {
        for (; x < hi; ++x) {
          const int64_t cx = bx + adelta[x], cy = by + ddelta[x];
          const int x0 = (int)(cx >> FB), y0i = (int)(cy >> FB);
          const int fx = (int)(cx & (ONE - 1)), fy = (int)(cy & (ONE - 1));
          const uint8_t* p0 = src + (size_t)y0i * sstride + (size_t)x0 * ch;
          const uint8_t* p1 = p0 + sstride;
          uint8_t* o = out + (size_t)x * ch;
          for (int c = 0; c < ch; ++c) {
            int64_t t = (int64_t)(p0[c] * (ONE - fx) + p0[ch + c] * fx)
                            * (ONE - fy) +
                        (int64_t)(p1[c] * (ONE - fx) + p1[ch + c] * fx) * fy;
            o[c] = (uint8_t)((t + HALF2) >> (2 * FB));
          }
        }
      }
      for (; x < dw; ++x) checked(x);
    }
  });
}

// Nearest-neighbor warp of an int32 label image.
void warp_affine_i32(const int32_t* src, int sh, int sw,
                     int32_t* dst, int dh, int dw,
                     const double* M, int32_t border, int n_threads) {
  constexpr int FB = 10;
  constexpr int64_t ONE = 1 << FB;
  Affine inv = invert(M);
  std::vector<int64_t> adelta(dw), ddelta(dw);
  for (int x = 0; x < dw; ++x) {
    adelta[x] = (int64_t)std::llround(inv.a * x * ONE);
    ddelta[x] = (int64_t)std::llround(inv.d * x * ONE);
  }
  parallel_rows(dh, n_threads, [&](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      const int64_t bx = (int64_t)std::llround((inv.b * y + inv.c) * ONE);
      const int64_t by = (int64_t)std::llround((inv.e * y + inv.f) * ONE);
      int32_t* out = dst + (size_t)y * dw;
      for (int x = 0; x < dw; ++x) {
        const int xi = (int)((bx + adelta[x] + ONE / 2) >> FB);
        const int yi = (int)((by + ddelta[x] + ONE / 2) >> FB);
        out[x] = (xi < 0 || yi < 0 || xi >= sw || yi >= sh)
                     ? border : src[(size_t)yi * sw + xi];
      }
    }
  });
}

// Fused BGR uint8 -> normalized RGB float32: (px/255 - mean) / std.
void normalize_bgr_u8(const uint8_t* src, int h, int w,
                      const float* mean, const float* stddev,
                      float* dst, int n_threads) {
  float inv_std[3] = {1.f / stddev[0], 1.f / stddev[1], 1.f / stddev[2]};
  parallel_rows(h, n_threads, [&](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      const uint8_t* s = src + (size_t)y * w * 3;
      float* d = dst + (size_t)y * w * 3;
      for (int x = 0; x < w; ++x) {
        // BGR -> RGB swap
        d[x * 3 + 0] = (s[x * 3 + 2] / 255.f - mean[0]) * inv_std[0];
        d[x * 3 + 1] = (s[x * 3 + 1] / 255.f - mean[1]) * inv_std[1];
        d[x * 3 + 2] = (s[x * 3 + 0] / 255.f - mean[2]) * inv_std[2];
      }
    }
  });
}

// Undo PNG's per-row filters (PNG specification, section 9): `src` holds
// `rows` rows of 1 + `stride` bytes, each a filter type (0 None, 1 Sub,
// 2 Up, 3 Average, 4 Paeth) then the filtered bytes; `dst` receives the
// rows x stride reconstructed bytes. `bpp` is the bytes of one pixel (the
// left neighbour's distance). The row above the first is zero. Returns 0,
// or 1 + the index of the first row whose filter type is not 0-4.
int png_unfilter(const uint8_t* src, int rows, int stride, int bpp, uint8_t* dst) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* in = src + (size_t)y * (stride + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + (size_t)y * stride;
    const uint8_t* up = y > 0 ? out - stride : nullptr;
    switch (type) {
      case 0:
        std::memcpy(out, in, stride);
        break;
      case 1:
        for (int x = 0; x < stride; ++x)
          out[x] = (uint8_t)(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < stride; ++x)
          out[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          out[x] = (uint8_t)(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (x >= bpp && up) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[x] = (uint8_t)(in[x] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
