// JPEG decoder of the port's host data plane, bit-equal to libjpeg-turbo's
// default decompression (what cv2.imread returns): Huffman entropy decoding
// of SOF0 / SOF1 (sequential) and SOF2 (progressive) frames at 8 bits, the
// accurate integer IDCT (jidctint.c jpeg_idct_islow: CONST_BITS 13,
// PASS1_BITS 2, the range-limit table), fancy (triangle) upsampling of h2v1,
// h1v2 and h2v2 chroma with libjpeg-turbo's alternating rounding bias and
// edge rows, int_upsample replication for any other integral factor, and
// ycc_rgb_convert's fixed-point tables (SCALEBITS 16), written out as BGR.
//
// A sequential frame is transformed block by block as it is decoded. A
// progressive frame (jdphuff.c: DC first and refine, AC first with EOB runs
// and AC refine, spectral selection and successive approximation, single-
// component scans on the component's own block grid, restart intervals) is
// decoded into a whole-image coefficient buffer that goes through the same
// IDCT after EOI. libjpeg smooths the blocks (jdcoefct.c smoothing_ok) where
// a component's zigzag coefficients 1-9 are still incomplete at EOI; such a
// file fails here rather than decoding to other pixels.
//
// Colour space as jdapimin.c default_decompress_parms decides it: one
// component is grey; three are YCbCr under a JFIF marker, RGB under an Adobe
// APP14 marker of transform 0 (copied, no conversion), YCbCr under any other
// Adobe transform, and without either marker RGB only for the component ids
// 'R', 'G', 'B'; four are CMYK without an Adobe marker or under transform 0,
// YCCK under any other (jdcolor.c ycck_cmyk_convert); either comes out as
// BGR through OpenCV's icvCvt_CMYK2BGR_8u_C4C3R (which reads Adobe's
// inverted channels), the image cv2 returns for a 4-component JPEG under
// either flag. Anything else fails
// with a message and no image: lossless, hierarchical or arithmetic-coded
// frames, other precisions, 2 components, fractional sampling factors,
// missing tables, bad Huffman codes, illegal progressions, missing restart
// markers, DNL markers and data that ends before the last MCU or EOI.
//
// Compiled with dataplane.cpp into one library by data/native.py.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <string>
#include <vector>

namespace {

// zigzag -> natural order, with libjpeg's 16 guard entries for corrupt data
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Fail {
  std::string msg;
};

struct Huff {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (code length << 8) | symbol, 0 when the code is longer
  uint16_t look[512];
};

const int kLook = 9;

void build_huff(Huff& h, const uint8_t* bits, const uint8_t* vals, int nvals, bool dc) {
  // jdhuff.c jpeg_make_d_derived_tbl, with its checks
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) throw Fail{"bad Huffman table"};
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      h.valoffset[l] = p - (int32_t)huffcode[p];
      p += bits[l - 1];
      h.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.maxcode[17] = 0x7FFFFFFF;
  std::memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= kLook; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++p) {
      uint32_t lookbits = huffcode[p] << (kLook - l);
      for (int c = 0; c < (1 << (kLook - l)); ++c)
        h.look[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
    }
  }
  std::memcpy(h.vals, vals, nvals);
  if (dc)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) throw Fail{"bad Huffman table"};
  h.defined = true;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;          // downsampled width / height
  int bw = 0, bh = 0;          // blocks of the component's own grid
  int stride = 0, rows = 0;    // the plane (MCU-padded)
  int dcpred = 0;
  bool seen = false;
  std::vector<uint8_t> plane;
  // progressive frames: the coefficients of the MCU-padded block grid
  // (bstride blocks a row), the quantization table latched at the
  // component's first scan, and the Al of the last scan of each zigzag
  // coefficient (-1 before any), as libjpeg's coef_bits
  std::vector<int16_t> coef;
  int bstride = 0;
  uint16_t q[64];
  int coef_bits[64];
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;
  uint16_t qt[4][64];
  bool qdef[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int W = 0, H = 0, nc = 0, hmax = 1, vmax = 1, ri = 0;
  Comp comp[4];
  bool have_sof = false, jfif = false, adobe = false, progressive = false;
  int adobe_transform = -1;
  int eobrun = 0;
  // entropy reader
  uint64_t acc = 0;
  int nbits = 0, pad = 0;
  size_t bpos = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) throw Fail{"data ends inside a marker segment"};
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  int next_marker() {
    // skip to the next 0xFF xx (xx != 0, != 0xFF)
    for (;;) {
      if (pos >= n) throw Fail{"data ends before EOI"};
      if (d[pos] != 0xFF) throw Fail{"expected a marker"};
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) throw Fail{"data ends before EOI"};
      int m = d[pos++];
      if (m != 0) return m;
      throw Fail{"expected a marker"};
    }
  }

  void read_app(int m, size_t end) {
    size_t len = end - pos;
    const uint8_t* b = d + pos;
    if (m == 0xE0 && len >= 5 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && len >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq = u8(), tq = pq & 15;
      pq >>= 4;
      if (pq > 1 || tq > 3) throw Fail{"bad DQT"};
      for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = (uint16_t)(pq ? u16() : u8());
      qdef[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc = u8(), th = tc & 15;
      tc >>= 4;
      if (tc > 1 || th > 3) throw Fail{"bad DHT"};
      uint8_t bits[16], vals[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += bits[i] = (uint8_t)u8();
      if (total > 256 || pos + total > end) throw Fail{"bad DHT"};
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)u8();
      build_huff(tc ? ac[th] : dc[th], bits, vals, total, tc == 0);
    }
  }

  void read_sof(int m) {
    if (have_sof) throw Fail{"more than one frame"};
    if (m != 0xC0 && m != 0xC1 && m != 0xC2) {
      if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
        throw Fail{"lossless JPEG is not supported"};
      if (m == 0xC5 || m == 0xC6)
        throw Fail{"hierarchical JPEG is not supported"};
      throw Fail{"arithmetic-coded or hierarchical JPEG is not supported"};
    }
    progressive = m == 0xC2;
    int prec = u8();
    if (prec != 8) throw Fail{"only 8-bit JPEG is supported"};
    H = u16();
    W = u16();
    nc = u8();
    if (H <= 0 || W <= 0) throw Fail{"bad image size (or a DNL marker, not supported)"};
    if ((int64_t)W * H > (int64_t)1 << 30) throw Fail{"image larger than 2^30 pixels"};
    if (nc != 1 && nc != 3 && nc != 4)
      throw Fail{"only 1, 3 or 4 colour components are supported"};
    for (int i = 0; i < nc; ++i) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 || comp[i].tq > 3)
        throw Fail{"bad sampling factors or table"};
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      if (hmax % c.h || vmax % c.v) throw Fail{"fractional sampling factors are not supported"};
      c.dw = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
      c.plane.assign((size_t)c.stride * c.rows, 0);
      if (progressive) {
        c.bstride = c.stride / 8;
        c.coef.assign((size_t)c.bstride * (c.rows / 8) * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
      }
    }
    have_sof = true;
  }

  // --- entropy-coded segment reader ---
  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!hit_marker) {
        if (bpos >= n) {
          hit_marker = true;
        } else if (d[bpos] == 0xFF) {
          size_t q = bpos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0x00) {
            b = 0xFF;
            bpos = q + 1;
          } else {
            hit_marker = true;     // bpos stays on the marker
          }
        } else {
          b = d[bpos++];
        }
      }
      if (hit_marker) pad += 8;
      acc = (acc << 8) | (uint64_t)b;
      nbits += 8;
    }
  }
  inline int bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    int v = (int)((acc >> (nbits - k)) & ((1u << k) - 1));
    nbits -= k;
    return v;
  }
  inline int decode(const Huff& h) {
    if (nbits < 16) fill();
    int look = (int)((acc >> (nbits - kLook)) & ((1 << kLook) - 1));
    int e = h.look[look];
    if (e) {
      nbits -= e >> 8;
      return e & 0xFF;
    }
    int l = kLook + 1;
    int32_t code = (int32_t)((acc >> (nbits - l)) & ((1u << l) - 1));
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) throw Fail{"bad Huffman code"};
      code = (int32_t)((acc >> (nbits - l)) & ((1u << l) - 1));
    }
    nbits -= l;
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void check_overread() {
    if (pad > nbits) throw Fail{"data ends before the last MCU (truncated)"};
  }

  // at a restart boundary or the end of a scan: the reader must have used
  // its segment and stand on a marker
  void end_segment() {
    check_overread();
    if (!hit_marker) {
      size_t q = bpos;
      if (!(q + 1 < n && d[q] == 0xFF)) throw Fail{"extraneous bytes in the entropy-coded data"};
    }
    acc = 0;
    nbits = 0;
    pad = 0;
    hit_marker = false;
  }

  // the DC predictor plus a difference, failing where the int would
  // overflow (jdhuff.c JERR_BAD_DCT_COEF)
  static void add_dc(Comp& c, int s) {
    if ((c.dcpred >= 0 && s > INT32_MAX - c.dcpred) || (c.dcpred < 0 && s < INT32_MIN - c.dcpred))
      throw Fail{"DC coefficient out of range"};
    c.dcpred += s;
  }

  void decode_block(Comp& c, int16_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    int s = decode(dc[c.td]);
    if (s) s = extend(bits(s), s);
    add_dc(c, s);
    coef[0] = (int16_t)c.dcpred;
    const Huff& a = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = decode(a);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = (int16_t)extend(bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_DC_first / _DC_refine / _AC_first / _AC_refine,
  // one block each
  void dc_first(Comp& c, int16_t* blk, int al) {
    int s = decode(dc[c.td]);
    if (s) s = extend(bits(s), s);
    add_dc(c, s);
    blk[0] = (int16_t)(int)((unsigned)c.dcpred << al);
  }
  void dc_refine(int16_t* blk, int al) {
    if (bits(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }
  void ac_first(const Comp& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huff& t = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = decode(t), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(int)((unsigned)extend(bits(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits(r);
        --eobrun;
        break;
      }
    }
  }
  // a correction bit for each already-nonzero coefficient: 1 adds p1 to its
  // magnitude unless the bit is already set
  inline void refine(int16_t* t, int p1) {
    if (bits(1) && (*t & p1) == 0) *t = (int16_t)(*t + (*t >= 0 ? p1 : -p1));
  }
  void ac_refine(const Comp& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    const Huff& t = ac[c.ta];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) throw Fail{"bad Huffman code in a refinement scan"};
          s = bits(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        do {
          int16_t* th = blk + kNatural[k];
          if (*th != 0) {
            refine(th, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k)
        if (blk[kNatural[k]] != 0) refine(blk + kNatural[k], p1);
      --eobrun;
    }
  }

  void idct_block(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride);

  void read_sos() {
    if (!have_sof) throw Fail{"SOS before SOF"};
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) throw Fail{"bad SOS"};
    size_t end = pos - 1 + len - 2;
    Comp* sc[4];
    int tsel[4];
    for (int i = 0; i < ns; ++i) {
      int cid = u8();
      tsel[i] = u8();
      Comp* c = nullptr;
      for (int j = 0; j < nc; ++j)
        if (comp[j].id == cid) c = &comp[j];
      if (!c) throw Fail{"SOS names an unknown component"};
      sc[i] = c;
    }
    int ss = u8(), se = u8(), a = u8(), ah = a >> 4, al = a & 15;
    // the scan's kind: 0 sequential, 1 DC first, 2 DC refine, 3 AC first,
    // 4 AC refine (jdphuff.c start_pass_phuff_decoder's checks; libjpeg
    // only warns of an illegal progression, which fails here)
    int kind = 0;
    if (!progressive) {
      if (ss != 0 || se != 63 || a != 0) throw Fail{"a sequential scan is not 0-63"};
    } else {
      bool dc_band = ss == 0;
      if ((dc_band ? se != 0 : (ss > se || se > 63 || ns != 1)) ||
          (ah != 0 && al != ah - 1) || al > 13)
        throw Fail{"bad progressive scan parameters"};
      kind = dc_band ? (ah ? 2 : 1) : (ah ? 4 : 3);
      for (int i = 0; i < ns; ++i) {
        int* cb = sc[i]->coef_bits;
        if (!dc_band && cb[0] < 0) throw Fail{"an AC scan before the DC scan (bad progression)"};
        for (int k = ss; k <= se; ++k) {
          if (ah != (cb[k] < 0 ? 0 : cb[k])) throw Fail{"bad progression of successive approximation"};
          cb[k] = al;
        }
      }
    }
    for (int i = 0; i < ns; ++i) {
      Comp* c = sc[i];
      c->td = tsel[i] >> 4;
      c->ta = tsel[i] & 15;
      bool need_dc = kind <= 1, need_ac = kind == 0 || kind >= 3;
      if (c->td > 3 || c->ta > 3 || (need_dc && !dc[c->td].defined) ||
          (need_ac && !ac[c->ta].defined))
        throw Fail{"a scan uses an undefined Huffman table"};
      if (!qdef[c->tq]) throw Fail{"a component uses an undefined quantization table"};
      if (progressive && !c->seen) std::memcpy(c->q, qt[c->tq], sizeof(c->q));
      c->seen = true;
      c->dcpred = 0;
    }
    pos = end;
    bpos = pos;
    acc = 0;
    nbits = 0;
    pad = 0;
    hit_marker = false;
    eobrun = 0;

    alignas(16) int16_t coef[64];
    int mcux, mcuy;
    if (ns == 1) {
      mcux = sc[0]->bw;
      mcuy = sc[0]->bh;
    } else {
      mcux = (W + 8 * hmax - 1) / (8 * hmax);
      mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    }
    int total = mcux * mcuy, rst = 0;
    for (int m = 0; m < total; ++m) {
      if (ri && m && m % ri == 0) {
        end_segment();
        size_t q = bpos;
        while (q < n && d[q] == 0xFF) ++q;
        if (q >= n || d[q] != 0xD0 + (rst & 7)) throw Fail{"missing restart marker"};
        bpos = q + 1;
        ++rst;
        for (int i = 0; i < ns; ++i) sc[i]->dcpred = 0;
        eobrun = 0;
      }
      int mx = m % mcux, my = m / mcux;
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bwn = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; ++by)
          for (int bx = 0; bx < bwn; ++bx) {
            int x = mx * bwn + bx, y = my * bh + by;
            if (kind == 0) {
              decode_block(c, coef);
              idct_block(coef, qt[c.tq], c.plane.data() + (size_t)y * 8 * c.stride + x * 8,
                         c.stride);
              continue;
            }
            int16_t* blk = c.coef.data() + ((size_t)y * c.bstride + x) * 64;
            switch (kind) {
              case 1: dc_first(c, blk, al); break;
              case 2: dc_refine(blk, al); break;
              case 3: ac_first(c, blk, ss, se, al); break;
              default: ac_refine(c, blk, ss, se, al); break;
            }
          }
      }
      check_overread();
    }
    end_segment();
    pos = bpos;
  }

  // After EOI of a progressive frame: every component has had its DC scan,
  // no block would be smoothed, and the coefficients go through the IDCT.
  void finish_progressive() {
    static const int kQpos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool smooth_ok = true, incomplete = false;
    for (int i = 0; i < nc; ++i) {
      const Comp& c = comp[i];
      if (c.coef_bits[0] < 0) throw Fail{"a component has no DC scan (truncated)"};
      for (int k = 0; k < 10; ++k)
        if (c.q[kQpos[k]] == 0) smooth_ok = false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) incomplete = true;
    }
    if (smooth_ok && incomplete)
      throw Fail{"progressive data ends with coefficients 1-9 incomplete, which libjpeg "
                 "smooths across blocks (not supported)"};
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      for (int y = 0; y < c.rows / 8; ++y)
        for (int x = 0; x < c.bstride; ++x)
          idct_block(c.coef.data() + ((size_t)y * c.bstride + x) * 64, c.q,
                     c.plane.data() + (size_t)y * 8 * c.stride + x * 8, c.stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  void parse(bool headers_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw Fail{"not a JPEG file"};
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {
        if (!have_sof) throw Fail{"no frame before EOI"};
        for (int i = 0; i < nc; ++i)
          if (!comp[i].seen) throw Fail{"a component has no scan (truncated)"};
        if (progressive && !headers_only) finish_progressive();
        return;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) throw Fail{"unexpected marker"};
      if (m == 0xDA) {
        if (headers_only) return;
        read_sos();
        continue;
      }
      int len = u16();
      if (len < 2 || pos + len - 2 > n) throw Fail{"truncated marker segment"};
      size_t end = pos + len - 2;
      if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDD) {
        if (len != 4) throw Fail{"bad DRI"};
        ri = u16();
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m);
      } else if (m == 0xCC) {
        throw Fail{"arithmetic-coded JPEG is not supported"};
      } else if (m == 0xDC) {
        throw Fail{"DNL markers are not supported"};
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m, end);
      }
      if (pos > end) throw Fail{"bad marker segment length"};
      pos = end;
    }
  }

  int color_space() const {
    // 0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK (jdapimin.c
    // default_decompress_parms)
    if (nc == 1) return 0;
    if (nc == 4) return adobe && adobe_transform != 0 ? 4 : 3;
    if (jfif) return 1;
    if (adobe) return adobe_transform == 0 ? 2 : 1;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return 2;
    return 1;
  }

  void upsample(const Comp& c, std::vector<uint8_t>& out);
  void output(uint8_t* dst, bool color);
};

// jidctint.c jpeg_idct_islow
const int CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

uint8_t g_range[1024];   // the post-IDCT range-limit table, indexed by x & 1023
struct RangeInit {
  RangeInit() {
    for (int v = 0; v < 1024; ++v)
      g_range[v] = (uint8_t)(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
  }
} g_range_init;

inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

void Decoder::idct_block(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    // DEQUANTIZE with ISLOW_MULT_TYPE short
    auto dq = [&](int r) { return (int64_t)((int32_t)in[8 * r] * (int32_t)(int16_t)qq[8 * r]); };
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dcval = (int32_t)(dq(0) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dcval;
      continue;
    }
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    ws[0 + c] = descale(tmp10 + tmp3, sh);
    ws[56 + c] = descale(tmp10 - tmp3, sh);
    ws[8 + c] = descale(tmp11 + tmp2, sh);
    ws[48 + c] = descale(tmp11 - tmp2, sh);
    ws[16 + c] = descale(tmp12 + tmp1, sh);
    ws[40 + c] = descale(tmp12 - tmp1, sh);
    ws[24 + c] = descale(tmp13 + tmp0, sh);
    ws[32 + c] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = g_range[descale(w[0], PASS1_BITS + 3) & 1023];
      for (int i = 0; i < 8; ++i) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = g_range[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = g_range[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = g_range[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = g_range[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = g_range[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = g_range[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = g_range[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = g_range[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// The component at full size (W x H), as jdsample.c's upsamplers give it.
// Rows above the first and below the last (downsampled_height) repeat the
// edge row, as jdmainct.c's context pointers do.
void Decoder::upsample(const Comp& c, std::vector<uint8_t>& out) {
  out.resize((size_t)W * H);
  const int hx = hmax / c.h, vy = vmax / c.v, dw = c.dw, dh = c.dh;
  auto row = [&](int r) {
    return c.plane.data() + (size_t)std::min(std::max(r, 0), dh - 1) * c.stride;
  };
  std::vector<uint8_t> tmp(2 * (size_t)dw + 2);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out.data() + (size_t)y * W;
    if (hx == 1 && vy == 1) {
      std::memcpy(o, row(y), W);
    } else if (hx == 2 && vy == 1 && dw > 2) {          // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      uint8_t* t = tmp.data();
      t[0] = in[0];
      t[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = in[i] * 3;
        t[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        t[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      t[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      t[2 * dw - 1] = in[dw - 1];
      std::memcpy(o, t, W);
    } else if (hx == 1 && vy == 2) {                    // h1v2_fancy_upsample
      int r = y >> 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (hx == 2 && vy == 2 && dw > 2) {          // h2v2_fancy_upsample
      int r = y >> 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
      uint8_t* t = tmp.data();
      int this_s = in0[0] * 3 + in1[0], next_s = in0[1] * 3 + in1[1], last_s;
      t[0] = (uint8_t)((this_s * 4 + 8) >> 4);
      t[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
      last_s = this_s;
      this_s = next_s;
      for (int i = 1; i < dw - 1; ++i) {
        next_s = in0[i + 1] * 3 + in1[i + 1];
        t[2 * i] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
        t[2 * i + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
        last_s = this_s;
        this_s = next_s;
      }
      t[2 * dw - 2] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
      t[2 * dw - 1] = (uint8_t)((this_s * 4 + 7) >> 4);
      std::memcpy(o, t, W);
    } else {                                            // int_upsample / h2v1 / h2v2
      const uint8_t* in = c.plane.data() + (size_t)(y / vy) * c.stride;
      for (int x = 0; x < W; ++x) o[x] = in[x / hx];
    }
  }
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int32_t half = 1 << (SB - 1);
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
} g_ycc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void Decoder::output(uint8_t* dst, bool color) {
  int cs = color_space();
  if (cs == 0) {
    std::vector<uint8_t> g;
    upsample(comp[0], g);
    if (!color) {
      std::memcpy(dst, g.data(), g.size());
    } else {
      for (size_t i = 0; i < g.size(); ++i) dst[3 * i] = dst[3 * i + 1] = dst[3 * i + 2] = g[i];
    }
    return;
  }
  std::vector<uint8_t> p0, p1, p2;
  upsample(comp[0], p0);
  upsample(comp[1], p1);
  upsample(comp[2], p2);
  const size_t N = (size_t)W * H;
  if (cs >= 3) {
    std::vector<uint8_t> p3;
    upsample(comp[3], p3);
    for (size_t i = 0; i < N; ++i) {
      int c = p0[i], m = p1[i], y = p2[i], k = p3[i];
      if (cs == 4) {                   // jdcolor.c ycck_cmyk_convert
        int luma = p0[i], cb = p1[i], cr = p2[i];
        c = clamp255(255 - (luma + g_ycc.cr_r[cr]));
        m = clamp255(255 - (luma + (int)((g_ycc.cb_g[cb] + g_ycc.cr_g[cr]) >> 16)));
        y = clamp255(255 - (luma + g_ycc.cb_b[cb]));
      }
      // OpenCV icvCvt_CMYK2BGR_8u_C4C3R
      dst[3 * i + 2] = (uint8_t)(k - ((255 - c) * k >> 8));
      dst[3 * i + 1] = (uint8_t)(k - ((255 - m) * k >> 8));
      dst[3 * i] = (uint8_t)(k - ((255 - y) * k >> 8));
    }
    return;
  }
  if (cs == 2) {
    for (size_t i = 0; i < N; ++i) {
      dst[3 * i] = p2[i];
      dst[3 * i + 1] = p1[i];
      dst[3 * i + 2] = p0[i];
    }
    return;
  }
  for (size_t i = 0; i < N; ++i) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    dst[3 * i + 2] = clamp255(y + g_ycc.cr_r[cr]);
    dst[3 * i + 1] = clamp255(y + (int)((g_ycc.cb_g[cb] + g_ycc.cr_g[cr]) >> 16));
    dst[3 * i] = clamp255(y + g_ycc.cb_b[cb]);
  }
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Header of the JPEG in data[0:n): info = {height, width, components,
// colour space (0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK)}. 0 on success, else 1 and a
// message in err.
int jpeg_info(const uint8_t* data, int64_t n, int* info, char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.parse(true);
    if (!dec.have_sof) throw Fail{"no frame header before the first scan"};
    info[0] = dec.H;
    info[1] = dec.W;
    info[2] = dec.nc;
    info[3] = dec.color_space();
    return 0;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 1;
  }
}

// Decode the JPEG in data[0:n) into out: (H, W) grey or (H, W, 3) BGR (also
// of a CMYK / YCCK file) when color is 0 (cv2.IMREAD_UNCHANGED), always
// (H, W, 3) BGR when color is 1
// (the colour conversion of cv2.IMREAD_COLOR). out holds the size jpeg_info
// gives. 0 on success, else 1 and a message in err.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, int color,
                char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.parse(false);
    int ch = (dec.nc == 1 && !color) ? 1 : 3;
    if ((int64_t)dec.W * dec.H * ch != out_size) throw Fail{"output buffer size mismatch"};
    dec.output(out, color != 0);
    return 0;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 1;
  }
}

}  // extern "C"
