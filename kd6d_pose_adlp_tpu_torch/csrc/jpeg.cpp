// JPEG decoder of the port's host data plane, bit-equal to libjpeg-turbo's
// default decompression as cv2.imread drives it (the stdio source, the
// default error manager): Huffman entropy decoding of SOF0 / SOF1
// (sequential) and SOF2 (progressive) frames at 8 bits, the accurate integer
// IDCT (jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2) as its SIMD
// version computes it, fancy (triangle) upsampling of h2v1, h1v2 and h2v2
// chroma with libjpeg-turbo's alternating rounding bias and edge rows,
// int_upsample replication for any other integral factor, and
// ycc_rgb_convert's fixed-point tables (SCALEBITS 16), written out as BGR.
//
// A file whose first scan holds every component is decoded and transformed
// block by block in that one scan, as decompress_onepass does; anything
// after it is never read. Any other file (a progressive frame, or a
// sequential one of several scans) is decoded into a whole-image coefficient
// buffer up to EOI (jdphuff.c: DC first and refine, AC first with EOB runs
// and AC refine, spectral selection and successive approximation, single-
// component scans on the component's own block grid) and transformed after
// it; a progressive frame whose zigzag coefficients 1-9 are still
// incomplete goes through libjpeg-turbo's block smoothing first (jdcoefct.c
// smoothing_ok / decompress_smooth_data: the 5x5 DC window, the DC itself
// re-estimated while no AC coefficient is known, the previous scan's
// coefficient bits below the last iMCU row its data reached).
//
// Damaged data is recovered as libjpeg does it: bytes past the end of the
// file read as the stdio source's fake EOI (FF D9 repeated); a marker met
// inside a scan ends its data, the MCU in progress decodes from zero bits
// and every later MCU of the segment is skipped (zero blocks, 128 after
// the IDCT, or the coefficients earlier scans left); a bad Huffman code
// decodes as 0 after 17 bits; garbage before a marker is skipped; a wrong
// or missing restart marker goes through jpeg_resync_to_restart's three
// actions; bad progressions and scan parameters that libjpeg only warns
// of are decoded as they stand; a sequential file's undefined tables 0 and 1
// are the standard ones (jstdhuff.c). Where libjpeg stops with an error
// (ERREXIT: no frame or scan before EOI, bad tables, lengths, sampling
// factors or component counts, a second SOI or frame, an unknown marker, a
// hierarchical frame, a zero height as a DNL file has, ...), the decode
// fails as "corrupt" and cv2.imread gives None. Arithmetic-coded, lossless
// and 12-bit frames, which libjpeg-turbo decodes, fail as "unsupported".
// The IDCT is the SIMD version's arithmetic, which damaged coefficients can
// take out of the range where it equals the C version's (16-bit wraps and
// saturation where the C version's range-limit table wraps).
//
// Colour space as jdapimin.c default_decompress_parms decides it: one
// component is grey; three are YCbCr under a JFIF marker, RGB under an Adobe
// APP14 marker of transform 0 (copied, no conversion), YCbCr under any other
// Adobe transform, and without either marker RGB only for the component ids
// 'R', 'G', 'B'; four are CMYK without an Adobe marker or under transform 0,
// YCCK under any other (jdcolor.c ycck_cmyk_convert); either comes out as
// BGR through OpenCV's icvCvt_CMYK2BGR_8u_C4C3R (which reads Adobe's
// inverted channels), the image cv2 returns for a 4-component JPEG under
// either flag.
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

// where libjpeg stops with an error: cv2.imread gives None
struct Fatal {
  std::string msg;
};
// a file libjpeg-turbo decodes and this decoder does not
struct Unsupported {
  std::string msg;
};

// a DHT table as defined (bits[1..16], values), turned into a decoding
// table when a scan starts, as libjpeg does
struct HuffSpec {
  bool defined = false;
  uint8_t bits[17];
  uint8_t vals[256];
};

struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (code length << 8) | symbol, 0 when the code is longer
  uint16_t look[512];
};

const int kLook = 9;

// jstdhuff.c: the tables libjpeg installs in slots 0 and 1 when the
// header defines none there
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

void std_table(HuffSpec& s, int which) {
  std::memcpy(s.bits, kStdBits[which], 17);
  std::memset(s.vals, 0, sizeof(s.vals));
  if (which < 2)
    std::memcpy(s.vals, kStdDcVals, sizeof(kStdDcVals));
  else
    std::memcpy(s.vals, which == 2 ? kStdAcLuma : kStdAcChroma, 162);
  s.defined = true;
}

void build_huff(Huff& h, const HuffSpec& s, bool dc) {
  // jdhuff.c jpeg_make_d_derived_tbl, with its checks
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (p + s.bits[l] > 256) throw Fatal{"bad Huffman table"};
    for (int i = 0; i < s.bits[l]; ++i) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) throw Fatal{"bad Huffman table"};
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s.bits[l]) {
      h.valoffset[l] = p - (int32_t)huffcode[p];
      p += s.bits[l];
      h.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.maxcode[17] = 0x7FFFFFFF;
  std::memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= kLook; ++l) {
    for (int i = 0; i < s.bits[l]; ++i, ++p) {
      uint32_t lookbits = huffcode[p] << (kLook - l);
      for (int c = 0; c < (1 << (kLook - l)); ++c)
        h.look[lookbits + c] = (uint16_t)((l << 8) | s.vals[p]);
    }
  }
  std::memcpy(h.vals, s.vals, sizeof(h.vals));
  if (dc)
    for (int i = 0; i < nsym; ++i)
      if (s.vals[i] > 15) throw Fatal{"bad Huffman table"};
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;          // downsampled width / height
  int bw = 0, bh = 0;          // blocks of the component's own grid
  int stride = 0, rows = 0;    // the plane (MCU-padded)
  int dcpred = 0;
  bool latched = false;        // its quantization table copied (first scan)
  std::vector<uint8_t> plane;
  // the coefficients of the MCU-padded block grid (bstride blocks a row)
  // of a file of several scans, the quantization table latched at the
  // component's first scan (zeros before), and libjpeg's coef_bits: the Al
  // of the last scan of each zigzag coefficient (-1 before any), and their
  // values before the component's latest scan (coefficients 0-9)
  std::vector<int16_t> coef;
  int bstride = 0;
  uint16_t q[64] = {};
  int coef_bits[64];
  int prev_bits[10];
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;              // the source: the file, then FF D9 repeated
  int unread = 0;              // libjpeg's unread_marker
  uint16_t qt[4][64];
  bool qdef[4] = {false, false, false, false};
  HuffSpec dcs[4], acs[4];
  Huff dc[4], ac[4];
  int W = 0, H = 0, nc = 0, prec = 0, hmax = 1, vmax = 1, ri = 0, cspace = 0;
  int mcux_all = 0, mcuy_all = 0;
  Comp comp[10];
  bool have_sof = false, jfif = false, adobe = false, progressive = false;
  bool arith = false, lossless = false, multi = false;
  int adobe_transform = -1;
  // the current scan
  Comp* sc[4];
  int ns = 0, ss = 0, se = 0, ah = 0, al = 0, scans = 0;
  // entropy reader
  uint64_t acc = 0;
  int nbits = 0, pad = 0, eobrun = 0;
  bool insufficient = false;
  int last_good = 0;           // libjpeg's last_good_iMCU_row

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  inline int at(size_t p) const { return p < n ? d[p] : ((p - n) & 1) ? 0xD9 : 0xFF; }
  int u8() { return at(pos++); }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // jdmarker.c next_marker: skip anything up to FF xx (xx not 0 or FF)
  int next_marker() {
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do c = u8();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_variable() {
    long len = u16() - 2;
    if (len > 0) pos += (size_t)len;
  }

  // get_interesting_appn: the first 14 bytes of APP0 / APP14
  void read_appn(int m) {
    long len = u16() - 2;
    int k = len >= 14 ? 14 : len > 0 ? (int)len : 0;
    uint8_t b[14];
    for (int i = 0; i < k; ++i) b[i] = (uint8_t)u8();
    len -= k;
    if (m == 0xE0 && k >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && k >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    if (len > 0) pos += (size_t)len;
  }

  void read_dqt() {
    long len = u16() - 2;
    while (len > 0) {
      --len;
      int pq = u8(), t = pq & 15;
      pq >>= 4;
      if (t >= 4) throw Fatal{"bad DQT table index"};
      for (int i = 0; i < 64; ++i) qt[t][kNatural[i]] = (uint16_t)(pq ? u16() : u8());
      qdef[t] = true;
      len -= pq ? 128 : 64;
    }
    if (len != 0) throw Fatal{"bad DQT length"};
  }

  void read_dht() {
    long len = u16() - 2;
    while (len > 16) {
      int index = u8();
      HuffSpec s;
      s.bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) count += s.bits[i] = (uint8_t)u8();
      len -= 17;
      if (count > 256 || count > len) throw Fatal{"bad Huffman table"};
      std::memset(s.vals, 0, sizeof(s.vals));
      for (int i = 0; i < count; ++i) s.vals[i] = (uint8_t)u8();
      len -= count;
      bool is_ac = index & 0x10;
      if (is_ac) index -= 0x10;
      if (index < 0 || index >= 4) throw Fatal{"bad DHT table index"};
      s.defined = true;
      (is_ac ? acs : dcs)[index] = s;
    }
    if (len != 0) throw Fatal{"bad DHT length"};
  }

  // get_dac: arithmetic conditioning, checked and unused
  void read_dac() {
    long len = u16() - 2;
    while (len > 0) {
      int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) throw Fatal{"bad DAC table index"};
      if (index < 16 && (val & 15) > (val >> 4)) throw Fatal{"bad DAC value"};
    }
    if (len != 0) throw Fatal{"bad DAC length"};
  }

  void read_sof(int m) {
    if (have_sof) throw Fatal{"two frame markers"};
    progressive = m == 0xC2 || m == 0xCA;
    lossless = m == 0xC3 || m == 0xCB;
    arith = m >= 0xC9;
    long len = u16();
    prec = u8();
    H = u16();
    W = u16();
    nc = u8();
    len -= 8;
    if (H <= 0 || W <= 0 || nc <= 0) throw Fatal{"empty image (or a DNL height)"};
    if (len != nc * 3) throw Fatal{"bad SOF length"};
    if (nc > 10) throw Fatal{"more than 10 components"};
    for (int i = 0; i < nc; ++i) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = (hv >> 4) & 15;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
    }
    have_sof = true;
  }

  void read_sos() {
    if (!have_sof) throw Fatal{"SOS before SOF"};
    int len = u16();
    int k = u8();
    if (len != k * 2 + 6 || k < 1 || k > 4) throw Fatal{"bad SOS length"};
    ns = k;
    Comp* cur[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < ns; ++i) {
      int cid = u8(), tsel = u8();
      Comp* c = nullptr;
      // jdmarker.c get_sos: the first component of that id whose slot in
      // the scan's list is still free
      for (int ci = 0; ci < nc && ci < 4; ++ci)
        if (comp[ci].id == cid && !cur[ci]) {
          c = &comp[ci];
          break;
        }
      if (!c) throw Fatal{"SOS names an unknown component"};
      cur[i] = c;
      c->td = (tsel >> 4) & 15;
      c->ta = tsel & 15;
      for (int j = 0; j < i; ++j)
        if (cur[j] == c) throw Fatal{"SOS names a component twice"};
    }
    for (int i = 0; i < ns; ++i) sc[i] = cur[i];
    ss = u8();
    se = u8();
    int a = u8();
    ah = (a >> 4) & 15;
    al = a & 15;
    ++scans;
  }

  // jdmarker.c read_markers: the markers up to the next SOS (returns 0xDA)
  // or EOI (0xD9)
  int read_markers() {
    for (;;) {
      int m = unread ? unread : next_marker();
      unread = 0;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA: case 0xCB:
          read_sof(m);
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xCD: case 0xCE: case 0xCF:
          throw Fatal{"hierarchical JPEG (not supported by libjpeg)"};
        case 0xD8:
          throw Fatal{"a second SOI marker"};
        case 0xDA:
          read_sos();
          return m;
        case 0xD9:
          return m;
        case 0xC4: read_dht(); break;
        case 0xCC: read_dac(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD:
          if (u16() != 4) throw Fatal{"bad DRI length"};
          ri = u16();
          break;
        case 0xE0: case 0xEE: read_appn(m); break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        case 0x01:
          break;
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
            skip_variable();
            break;
          }
          throw Fatal{"unknown JPEG marker"};
      }
    }
  }

  // jdinput.c initial_setup and what jpeg_start_decompress checks before
  // the first scan
  void initial_setup() {
    if (W > 65500 || H > 65500) throw Fatal{"image too big"};
    if (arith) throw Unsupported{"arithmetic-coded JPEG is not supported"};
    if (lossless) throw Unsupported{"lossless JPEG is not supported"};
    if (prec == 12) throw Unsupported{"12-bit JPEG is not supported"};
    if (prec != 8) throw Fatal{"bad data precision"};
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Fatal{"bad sampling factors"};
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc != 1 && nc != 3 && nc != 4)
      throw Fatal{"no colour conversion from this number of components"};
    for (int i = 0; i < nc; ++i)
      if (hmax % comp[i].h || vmax % comp[i].v) throw Fatal{"fractional sampling factors"};
    if ((int64_t)W * H > (int64_t)1 << 30) throw Fatal{"image larger than 2^30 pixels"};
    // jdapimin.c default_decompress_parms: 0 grey, 1 YCbCr, 2 RGB, 3 CMYK,
    // 4 YCCK
    if (nc == 1)
      cspace = 0;
    else if (nc == 4)
      cspace = adobe && adobe_transform != 0 ? 4 : 3;
    else if (jfif)
      cspace = 1;
    else if (adobe)
      cspace = adobe_transform == 0 ? 2 : 1;
    else
      cspace = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66 ? 2 : 1;
    mcux_all = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy_all = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      c.dw = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.stride = mcux_all * c.h * 8;
      c.rows = mcuy_all * c.v * 8;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 10, -1);
    }
  }

  // jdinput.c start_input_pass: per_scan_setup, latch_quant_tables, the
  // entropy decoder's start_pass
  void start_scan() {
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) throw Fatal{"too many blocks in an MCU"};
    }
    for (int i = 0; i < ns; ++i) {
      Comp* c = sc[i];
      if (c->latched) continue;
      if (c->tq >= 4 || !qdef[c->tq]) throw Fatal{"a component uses an undefined quantization table"};
      std::memcpy(c->q, qt[c->tq], sizeof(c->q));
      c->latched = true;
    }
    if (!progressive) {
      // jdhuff.c start_pass_huff_decoder (scan parameters other than 0-63
      // are only warned of)
      for (int i = 0; i < ns; ++i) {
        derive(sc[i]->td, true);
        derive(sc[i]->ta, false);
      }
    } else {
      // jdphuff.c start_pass_phuff_decoder
      bool dc_band = ss == 0;
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) throw Fatal{"bad progressive scan parameters"};
      for (int i = 0; i < ns; ++i) {
        Comp* c = sc[i];
        for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
          if (k < 10) c->prev_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
        if (dc_band) {
          if (ah == 0) derive(c->td, true);
        } else {
          derive(c->ta, false);
        }
      }
    }
    for (int i = 0; i < ns; ++i) sc[i]->dcpred = 0;
    acc = 0;
    nbits = 0;
    pad = 0;
    eobrun = 0;
    insufficient = false;
  }

  void derive(int t, bool is_dc) {
    if (t >= 4 || !(is_dc ? dcs : acs)[t].defined) throw Fatal{"a scan uses an undefined Huffman table"};
    build_huff(is_dc ? dc[t] : ac[t], (is_dc ? dcs : acs)[t], is_dc);
  }

  // --- entropy-coded segment reader (jdhuff.c jpeg_fill_bit_buffer): a
  // marker ends the data, zero bits follow it ---
  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!unread) {
        b = pos < n ? d[pos++] : at(pos++);
        if (b == 0xFF) {
          int c;
          do c = at(pos++);
          while (c == 0xFF);
          if (c != 0) {
            unread = c;
            b = 0;
          }
        }
      }
      if (unread) pad += 8;
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
  // jdhuff.c HUFF_DECODE / jpeg_huff_decode: a code longer than 16 bits
  // reads as symbol 0 after 17 bits
  inline int decode(const Huff& h) {
    if (nbits < 17) fill();
    int look = (int)((acc >> (nbits - kLook)) & ((1 << kLook) - 1));
    int e = h.look[look];
    if (e) {
      nbits -= e >> 8;
      return e & 0xFF;
    }
    int l = kLook + 1;
    int32_t code = (int32_t)((acc >> (nbits - l)) & ((1u << l) - 1));
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = (int32_t)((acc >> (nbits - l)) & ((1u << l) - 1));
    }
    if (l > 16) {
      nbits -= 17;
      return 0;
    }
    nbits -= l;
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  // jdhuff.c process_restart with jdmarker.c read_restart_marker and
  // jpeg_resync_to_restart
  void process_restart(int& next_rst) {
    acc = 0;
    nbits = 0;
    pad = 0;
    if (!unread) unread = next_marker();
    if (unread == 0xD0 + next_rst) {
      unread = 0;
    } else {
      int marker = unread;
      for (;;) {
        int action;
        if (marker < 0xC0)
          action = 2;
        else if (marker < 0xD0 || marker > 0xD7)
          action = 3;
        else if (marker == 0xD0 + ((next_rst + 1) & 7) || marker == 0xD0 + ((next_rst + 2) & 7))
          action = 3;
        else if (marker == 0xD0 + ((next_rst - 1) & 7) || marker == 0xD0 + ((next_rst - 2) & 7))
          action = 2;
        else
          action = 1;
        if (action == 1) {
          unread = 0;
          break;
        }
        if (action == 3) break;
        unread = marker = next_marker();
      }
    }
    next_rst = (next_rst + 1) & 7;
    for (int i = 0; i < ns; ++i) sc[i]->dcpred = 0;
    eobrun = 0;
    if (!unread) insufficient = false;
  }

  // the DC predictor plus a difference; libjpeg stops where the int would
  // overflow (jdhuff.c JERR_BAD_DCT_COEF)
  static void add_dc(Comp& c, int s) {
    if ((c.dcpred >= 0 && s > INT32_MAX - c.dcpred) || (c.dcpred < 0 && s < INT32_MIN - c.dcpred))
      throw Fatal{"DC coefficient out of range"};
    c.dcpred += s;
  }

  void decode_block(Comp& c, int16_t* coef) {
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
  void dc_first(Comp& c, int16_t* blk) {
    int s = decode(dc[c.td]);
    if (s) s = extend(bits(s), s);
    add_dc(c, s);
    blk[0] = (int16_t)(int)((unsigned)c.dcpred << al);
  }
  void dc_refine(int16_t* blk) {
    if (bits(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }
  void ac_first(const Comp& c, int16_t* blk) {
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
  void ac_refine(const Comp& c, int16_t* blk) {
    const int p1 = 1 << al;
    const Huff& t = ac[c.ta];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          // a size other than 1 is only warned of (JWRN_HUFF_BAD_CODE)
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

  // One scan, MCU by MCU (jdcoefct.c decompress_onepass / consume_data):
  // once the data has run out, the segment's later MCUs are skipped, as the
  // entropy decoders do while insufficient_data is set
  void decode_scan() {
    start_scan();
    int kind = 0;       // 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC refine
    if (progressive) kind = ss == 0 ? (ah ? 2 : 1) : (ah ? 4 : 3);
    int mcux, mcuy;
    if (ns == 1) {
      mcux = sc[0]->bw;
      mcuy = sc[0]->bh;
    } else {
      mcux = mcux_all;
      mcuy = mcuy_all;
    }
    alignas(16) int16_t coef[64];
    const int64_t total = (int64_t)mcux * mcuy;
    int next_rst = 0, to_go = ri;
    for (int64_t m = 0; m < total; ++m) {
      int mx = (int)(m % mcux), my = (int)(m / mcux);
      if (!insufficient) last_good = ns == 1 ? my / sc[0]->v : my;
      if (ri) {
        if (to_go == 0) {
          process_restart(next_rst);
          to_go = ri;
        }
        --to_go;
      }
      if (insufficient) continue;
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bwn = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; ++by)
          for (int bx = 0; bx < bwn; ++bx) {
            int x = mx * bwn + bx, y = my * bh + by;
            if (!multi) {
              std::memset(coef, 0, sizeof(coef));
              decode_block(c, coef);
              idct_block(coef, c.q, c.plane.data() + (size_t)y * 8 * c.stride + x * 8, c.stride);
              continue;
            }
            int16_t* blk = c.coef.data() + ((size_t)y * c.bstride + x) * 64;
            switch (kind) {
              case 0: decode_block(c, blk); break;
              case 1: dc_first(c, blk); break;
              case 2: dc_refine(blk); break;
              case 3: ac_first(c, blk); break;
              default: ac_refine(c, blk); break;
            }
          }
      }
      if (pad > nbits) insufficient = true;
    }
  }

  void smooth_component(Comp& c);
  void finish_multi();

  // jpeg_read_header, then (unless headers_only) the decompression
  void run(bool headers_only) {
    if (at(0) != 0xFF || at(1) != 0xD8) throw Fatal{"not a JPEG file"};
    pos = 2;
    if (read_markers() == 0xD9)
      throw Fatal{have_sof ? "a frame without a scan" : "no image before EOI"};
    initial_setup();
    if (headers_only) return;
    for (int t = 0; t < 2 && !progressive; ++t) {   // jdhuff.c jinit_huff_decoder
      if (!dcs[t].defined) std_table(dcs[t], t);
      if (!acs[t].defined) std_table(acs[t], 2 + t);
    }
    multi = progressive || ns < nc;
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      c.plane.assign((size_t)c.stride * c.rows, 128);
      if (multi) {
        c.bstride = c.stride / 8;
        c.coef.assign((size_t)c.bstride * (c.rows / 8) * 64, 0);
      }
    }
    for (;;) {
      decode_scan();
      if (!multi || read_markers() == 0xD9) break;
    }
    if (multi) finish_multi();
  }

  int color_space() const { return cspace; }
  void upsample(const Comp& c, std::vector<uint8_t>& out);
  void output(uint8_t* dst, bool color);
};

// jdcoefct.c smoothing_ok: every component's DC known, the quantizers of
// coefficients 0-9 nonzero, and some of coefficients 1-9 still inexact
void Decoder::finish_multi() {
  static const int kQpos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool smooth = progressive, useful = false;
  for (int i = 0; i < nc && smooth; ++i) {
    const Comp& c = comp[i];
    if (!c.latched || c.coef_bits[0] < 0) smooth = false;
    for (int k = 0; k < 10 && smooth; ++k)
      if (c.q[kQpos[k]] == 0) smooth = false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  for (int i = 0; i < nc; ++i) {
    Comp& c = comp[i];
    if (smooth && useful) {
      smooth_component(c);
    } else {
      for (int y = 0; y < c.bh; ++y)
        for (int x = 0; x < c.bw; ++x)
          idct_block(c.coef.data() + ((size_t)y * c.bstride + x) * 64, c.q,
                     c.plane.data() + (size_t)y * 8 * c.stride + x * 8, c.stride);
    }
    std::vector<int16_t>().swap(c.coef);
  }
}

inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return (int16_t)pred;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+), iMCU row by iMCU
// row: the DC values of the 5x5 blocks around each block (rows repeated at
// the image's edges as its block-row arithmetic gives them, columns slid
// along a row) estimate coefficients 1-9 that are still zero and inexact;
// while no AC coefficient of the component is known, the DC too
void Decoder::smooth_component(Comp& c) {
  const int T = mcuy_all, v = c.v;
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
                Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
  int cur_bits[10], prev_bits[10];
  for (int k = 0; k < 10; ++k) {
    cur_bits[k] = c.coef_bits[k];
    prev_bits[k] = scans > 1 ? c.prev_bits[k] : -1;
  }
  alignas(16) int16_t ws[64];
  auto row_ptr = [&](int y) { return c.coef.data() + (size_t)y * c.bstride * 64; };
  for (int r = 0; r < T; ++r) {
    int block_rows = v;
    if (r == T - 1) {
      block_rows = c.bh % v;
      if (block_rows == 0) block_rows = v;
    }
    const int* cb = r > last_good ? prev_bits : cur_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k)
      if (cb[k] != -1) change_dc = false;
    const int64_t image_block_rows = (int64_t)block_rows * T;
    for (int b = 0; b < block_rows; ++b) {
      const int64_t ibr = (int64_t)r * block_rows + b;
      const int y = r * v + b;
      const int16_t* cur = row_ptr(y);
      const int16_t* prev = ibr > 0 ? row_ptr(y - 1) : cur;
      const int16_t* pprev = ibr > 1 ? row_ptr(y - 2) : prev;
      const int16_t* next = ibr < image_block_rows - 1 ? row_ptr(y + 1) : cur;
      const int16_t* nnext = ibr < image_block_rows - 2 ? row_ptr(y + 2) : next;
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14,
          DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = pprev[0];
      DC06 = DC07 = DC08 = DC09 = DC10 = prev[0];
      DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
      DC16 = DC17 = DC18 = DC19 = DC20 = next[0];
      DC21 = DC22 = DC23 = DC24 = DC25 = nnext[0];
      const int last_col = c.bw - 1;
      for (int bn = 0; bn <= last_col; ++bn) {
        const size_t o = (size_t)bn * 64;
        std::memcpy(ws, cur + o, sizeof(ws));
        if (bn == 0 && bn < last_col) {
          DC04 = DC05 = pprev[o + 64];
          DC09 = DC10 = prev[o + 64];
          DC14 = DC15 = cur[o + 64];
          DC19 = DC20 = next[o + 64];
          DC24 = DC25 = nnext[o + 64];
        }
        if (bn + 1 < last_col) {
          DC05 = pprev[o + 128];
          DC10 = prev[o + 128];
          DC15 = cur[o + 128];
          DC20 = next[o + 128];
          DC25 = nnext[o + 128];
        }
        int Al;
        if ((Al = cb[1]) != 0 && ws[1] == 0) {
          int64_t num = Q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
               3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
               13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = smooth_pred(num, Q01, Al);
        }
        if ((Al = cb[2]) != 0 && ws[8] == 0) {
          int64_t num = Q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
               13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = smooth_pred(num, Q10, Al);
        }
        if ((Al = cb[3]) != 0 && ws[16] == 0) {
          int64_t num = Q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
               2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = smooth_pred(num, Q20, Al);
        }
        if ((Al = cb[4]) != 0 && ws[9] == 0) {
          int64_t num = Q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
               DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = smooth_pred(num, Q11, Al);
        }
        if ((Al = cb[5]) != 0 && ws[2] == 0) {
          int64_t num = Q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
               DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = smooth_pred(num, Q02, Al);
        }
        if (change_dc) {
          if ((Al = cb[6]) != 0 && ws[3] == 0)
            ws[3] = smooth_pred(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, Al);
          if ((Al = cb[7]) != 0 && ws[10] == 0)
            ws[10] = smooth_pred(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, Al);
          if ((Al = cb[8]) != 0 && ws[17] == 0)
            ws[17] = smooth_pred(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, Al);
          if ((Al = cb[9]) != 0 && ws[24] == 0)
            ws[24] = smooth_pred(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, Al);
          int64_t num = Q00 *
              (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
               42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
               42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
               2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = smooth_pred(num, Q00, 0);
        }
        idct_block(ws, c.q, c.plane.data() + (size_t)y * 8 * c.stride + bn * 8, c.stride);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

// jidctint.c jpeg_idct_islow as libjpeg-turbo's SIMD version computes it
// (jidctint-sse2 / -avx2, what cv2's build runs): the same fixed point
// (CONST_BITS 13, PASS1_BITS 2) with the odd part's products regrouped into
// pairs (pmaddwd), dequantized coefficients and the sums in0 +- in4, in3 +
// in7, in1 + in5 kept in 16 bits (they wrap), the first pass saturated to
// 16 bits, the output saturated to 0-255, and a block whose rows 1-7 are
// all zero transformed in the first pass as (DC * q) << 2 in 16 bits. On
// the coefficients of an intact file this is the C version's arithmetic;
// the damaged data of a recovered file can leave that range.
inline int16_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
inline int16_t sat16(int32_t x) { return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x); }
// pmaddwd: a * ca + b * cb in 32 bits
inline int32_t madd(int16_t a, int16_t ca, int16_t b, int16_t cb) {
  return add32((int32_t)a * ca, (int32_t)b * cb);
}

// One pass over eight lanes at once (the columns of the first pass, the rows
// of the second): in[k][l] is input k of lane l, out[k][l] = (result k +
// 2^(sh - 1)) >> sh before saturation. Straight-line code over the lanes,
// which the compiler vectorizes.
inline void idct_lanes(const int16_t (*in)[8], int sh, int32_t (*out)[8]) {
  const int32_t rnd = 1 << (sh - 1);
  for (int l = 0; l < 8; ++l) {
    const int16_t i0 = in[0][l], i1 = in[1][l], i2 = in[2][l], i3 = in[3][l], i4 = in[4][l],
                  i5 = in[5][l], i6 = in[6][l], i7 = in[7][l];
    const int32_t tmp3 = madd(i2, 10703, i6, 4433);         // FIX(0.541 + 0.765), FIX(0.541)
    const int32_t tmp2 = madd(i2, 4433, i6, -10704);        // FIX(0.541), FIX(0.541 - 1.848)
    const int32_t t0 = (int32_t)wrap16(i0 + i4) * 8192, t1 = (int32_t)wrap16(i0 - i4) * 8192;
    const int32_t tmp10 = add32(t0, tmp3), tmp13 = sub32(t0, tmp3);
    const int32_t tmp11 = add32(t1, tmp2), tmp12 = sub32(t1, tmp2);
    const int16_t z3s = wrap16(i3 + i7), z4s = wrap16(i1 + i5);
    const int32_t z3 = madd(z3s, -6436, z4s, 9633);         // FIX(1.176 - 1.962), FIX(1.176)
    const int32_t z4 = madd(z3s, 9633, z4s, 6437);          // FIX(1.176), FIX(1.176 - 0.390)
    const int32_t o0 = add32(madd(i7, -4927, i1, -7373), z3);
    const int32_t o3 = add32(madd(i7, -7373, i1, 4926), z4);
    const int32_t o1 = add32(madd(i5, -4176, i3, -20995), z4);
    const int32_t o2 = add32(madd(i5, -20995, i3, 4177), z3);
    out[0][l] = add32(add32(tmp10, o3), rnd) >> sh;
    out[7][l] = add32(sub32(tmp10, o3), rnd) >> sh;
    out[1][l] = add32(add32(tmp11, o2), rnd) >> sh;
    out[6][l] = add32(sub32(tmp11, o2), rnd) >> sh;
    out[2][l] = add32(add32(tmp12, o1), rnd) >> sh;
    out[5][l] = add32(sub32(tmp12, o1), rnd) >> sh;
    out[3][l] = add32(add32(tmp13, o0), rnd) >> sh;
    out[4][l] = add32(sub32(tmp13, o0), rnd) >> sh;
  }
}

void Decoder::idct_block(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  alignas(16) int16_t ws[8][8];   // the first pass, transposed: ws[column][row]
  int16_t ac = 0;
  for (int i = 8; i < 64; ++i) ac |= coef[i];
  if (!ac) {
    for (int c = 0; c < 8; ++c) {
      const int16_t v = wrap16(wrap16(coef[c] * (int16_t)q[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[c][r] = v;
    }
  } else {
    alignas(16) int16_t dq[8][8];
    alignas(16) int32_t o[8][8];
    for (int i = 0; i < 64; ++i) dq[i >> 3][i & 7] = wrap16(coef[i] * (int16_t)q[i]);
    idct_lanes(dq, 11, o);
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) ws[c][r] = sat16(o[r][c]);
  }
  alignas(16) int32_t o[8][8];    // o[column][row]
  idct_lanes(ws, 18, o);
  for (int r = 0; r < 8; ++r) {
    uint8_t* dst = out + (size_t)r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = sat16(o[c][r]);
      dst[c] = (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
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

// 0, or 1 and a message where libjpeg stops with an error (cv2.imread gives
// None), or 2 and a message for a file this decoder does not support
template <class F>
int guarded(F f, char* err, int errlen) {
  try {
    f();
    return 0;
  } catch (const Fatal& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const Unsupported& e) {
    set_err(err, errlen, e.msg);
    return 2;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 1;
  }
}

}  // namespace

extern "C" {

// Header of the JPEG in data[0:n), as jpeg_read_header reads it up to the
// first scan: info = {height, width, components, colour space (0 grey, 1
// YCbCr, 2 RGB, 3 CMYK, 4 YCCK)}. 0 on success, else 1 (corrupt: cv2.imread
// gives None) or 2 (unsupported) and a message in err.
int jpeg_info(const uint8_t* data, int64_t n, int* info, char* err, int errlen) {
  return guarded([&] {
    Decoder dec(data, (size_t)n);
    dec.run(true);
    info[0] = dec.H;
    info[1] = dec.W;
    info[2] = dec.nc;
    info[3] = dec.color_space();
  }, err, errlen);
}

// Decode the JPEG in data[0:n) into out: (H, W) grey or (H, W, 3) BGR (also
// of a CMYK / YCCK file) when color is 0 (cv2.IMREAD_UNCHANGED), always
// (H, W, 3) BGR when color is 1 (the colour conversion of cv2.IMREAD_COLOR).
// out holds the size jpeg_info gives. Returns as jpeg_info.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, int color,
                char* err, int errlen) {
  return guarded([&] {
    Decoder dec(data, (size_t)n);
    dec.run(false);
    int ch = (dec.nc == 1 && !color) ? 1 : 3;
    if ((int64_t)dec.W * dec.H * ch != out_size) throw Fatal{"output buffer size mismatch"};
    dec.output(out, color != 0);
  }, err, errlen);
}

}  // extern "C"
