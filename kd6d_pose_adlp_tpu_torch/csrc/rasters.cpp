// The per-byte and per-sample loops of the port's TIFF decoder (data/
// tiff.py), each as libtiff, which cv2.imread drives, decodes it, damaged
// data included:
//
//   tiff_lzw        libtiff's LZWDecode (MSB-first codes, 9 to 12 bits, the
//                   early change one code before the table fills, CLEAR and
//                   EOI, "Corrupted LZW table" and "Wrong length of decoded
//                   string" errors, a string cut where the output is full)
//   tiff_packbits   libtiff's PackBitsDecode (runs cut where the output is
//                   full, -128 a no-op)
//   tiff_hor_acc    predictor 2: horizontal accumulation of 8, 16 or 32-bit
//                   samples in native order, `stride` samples apart
//   tiff_fp_acc     predictor 3: byte accumulation, then the byte planes of
//                   each row (most significant first) back into native floats
//
// Return codes: 0 done, 1 an error libtiff reports after writing what it
// decoded (the caller decides), 2 a form the port does not decode. Compiled
// with dataplane.cpp, jpeg.cpp and cvarith.cpp into one library by
// data/native.py.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- TIFF LZW

struct LzwCode {
  int next;            // index of the prefix entry, -1 for none
  uint16_t length;     // string length, 0 for an unused entry
  uint8_t value;       // last byte of the string
  uint8_t firstchar;   // first byte of the string
};

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMin = 9, kBitsMax = 12;
constexpr int kCsize = (1 << kBitsMax) - 1 + 1024;  // MAXCODE(BITS_MAX) + 1024

}  // namespace

extern "C" {

// libtiff's LZWDecode of src[0:n) into dst[0:occ). Returns 0 when dst is
// full, 1 after an error (what was decoded stands, the rest of dst is 0),
// 2 for old-style (pre-TIFF 5.0) LZW.
int tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return 2;
  std::vector<LzwCode> tab(kCsize);
  for (int i = 0; i < 256; i++) tab[i] = LzwCode{-1, 1, (uint8_t)i, (uint8_t)i};
  int nbits = kBitsMin, nbitsmask = (1 << nbits) - 1;
  int free_ent = kFirst, maxcode = nbitsmask - 1, oldcode = -1;
  int64_t bitsleft = n * 8, pos = 0;
  uint64_t acc = 0;
  int accbits = 0;
  uint8_t* op = dst;
  auto next_code = [&]() -> int {
    if (bitsleft < nbits) return kEoi;                 // "not terminated with EOI code"
    while (accbits < nbits) {
      acc = (acc << 8) | src[pos++];
      accbits += 8;
    }
    accbits -= nbits;
    bitsleft -= nbits;
    return (int)((acc >> accbits) & ((1u << nbits) - 1));
  };
  int rc = 0;
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kCsize; i++) tab[i] = LzwCode{-1, 0, 0, 0};
        nbits = kBitsMin;
        nbitsmask = (1 << nbits) - 1;
        maxcode = nbitsmask - 1;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) { rc = 1; break; }            // "Corrupted LZW table"
      *op++ = (uint8_t)code;
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize || oldcode < 0) { rc = 1; break; }
    LzwCode& fe = tab[free_ent];
    fe.next = oldcode;
    fe.firstchar = tab[oldcode].firstchar;
    fe.length = (uint16_t)(tab[oldcode].length + 1);
    fe.value = code < free_ent ? tab[code].firstchar : fe.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
      if (free_ent >= kCsize) free_ent = -1;             // only CLEAR or EOI may follow
    }
    oldcode = code;
    if (code >= 256) {
      const LzwCode* cp = &tab[code];
      if (cp->length == 0) { rc = 1; break; }            // "Wrong length of decoded string"
      if (cp->length > occ) {                            // cut where the output is full
        int c = code;
        while (tab[c].length > occ) c = tab[c].next;
        uint8_t* tp = op + occ;
        do {
          *--tp = tab[c].value;
          c = tab[c].next;
        } while (--occ);
        break;
      }
      int len = cp->length, c = code;
      uint8_t* tp = op + len;
      do {
        *--tp = tab[c].value;
        c = tab[c].next;
      } while (c >= 0 && tp > op);
      op += len;
      occ -= len;
    } else {
      *op++ = (uint8_t)code;
      occ--;
    }
  }
  if (occ > 0) {
    std::memset(op, 0, (size_t)occ);                     // "Not enough data at scanline"
    return 1;
  }
  return rc;
}

// libtiff's PackBitsDecode of src[0:n) into dst[0:occ): 0 when dst is
// full, 1 when the data ends first (the rest of dst is 0).
int tiff_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ) {
  const uint8_t* bp = src;
  int64_t cc = n;
  uint8_t* op = dst;
  while (cc > 0 && occ > 0) {
    long b = (long)*bp++;
    cc--;
    if (b >= 128) b -= 256;
    if (b < 0) {
      if (b == -128) continue;
      long k = -b + 1;
      if (occ < k) k = (long)occ;                        // "Discarding ... bytes"
      if (cc == 0) break;                                // "lack of data"
      occ -= k;
      uint8_t v = *bp++;
      cc--;
      while (k-- > 0) *op++ = v;
    } else {
      if (occ < b + 1) b = (long)occ - 1;
      if (cc < b + 1) break;
      ++b;
      std::memcpy(op, bp, (size_t)b);
      op += b;
      occ -= b;
      bp += b;
      cc -= b;
    }
  }
  if (occ > 0) {
    std::memset(op, 0, (size_t)occ);
    return 1;
  }
  return 0;
}

// Predictor 2 on rows of native-order samples of `bytes` (1, 2 or 4) bytes,
// each sample adding the one `stride` samples before it (modulo 2^bits).
void tiff_hor_acc(uint8_t* buf, int64_t rows, int64_t row_bytes, int bytes, int stride) {
  int64_t wc = row_bytes / bytes;
  for (int64_t r = 0; r < rows; r++) {
    uint8_t* row = buf + r * row_bytes;
    if (bytes == 1) {
      for (int64_t i = stride; i < wc; i++) row[i] = (uint8_t)(row[i] + row[i - stride]);
    } else if (bytes == 2) {
      uint16_t* p = reinterpret_cast<uint16_t*>(row);
      for (int64_t i = stride; i < wc; i++) p[i] = (uint16_t)(p[i] + p[i - stride]);
    } else {
      uint32_t* p = reinterpret_cast<uint32_t*>(row);
      for (int64_t i = stride; i < wc; i++) p[i] = p[i] + p[i - stride];
    }
  }
}

// Predictor 3 (libtiff fpAcc) on rows of `bytes`-byte floats: the row's
// bytes accumulate `stride` apart, then byte plane k (most significant
// first) of sample i goes to byte (bytes - 1 - k) of native sample i.
void tiff_fp_acc(uint8_t* buf, int64_t rows, int64_t row_bytes, int bytes, int stride) {
  int64_t wc = row_bytes / bytes;
  std::vector<uint8_t> tmp((size_t)row_bytes);
  for (int64_t r = 0; r < rows; r++) {
    uint8_t* row = buf + r * row_bytes;
    for (int64_t i = stride; i < row_bytes; i++) row[i] = (uint8_t)(row[i] + row[i - stride]);
    std::memcpy(tmp.data(), row, (size_t)row_bytes);
    for (int64_t c = 0; c < wc; c++)
      for (int b = 0; b < bytes; b++) row[bytes * c + b] = tmp[(bytes - b - 1) * wc + c];
  }
}

}  // extern "C"
