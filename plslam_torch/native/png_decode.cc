// PNG decoder and zlib inflate; see png_decode.h.

#include "png_decode.h"

#include <cstdio>
#include <cstring>

namespace plslam_png {
namespace {

// ---- bit reader (deflate's bits are read least significant first) --------
struct Bits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  uint64_t used = 0;  // bits consumed

  Bits(const uint8_t* data, size_t size) : p(data), n(size) {}
  void fill() {
    while (cnt <= 56) {
      buf |= (uint64_t)(pos < n ? p[pos] : 0) << cnt;  // zeros past the end
      ++pos;
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    fill();
    return (uint32_t)(buf & ((1ull << k) - 1));
  }
  void drop(int k) {
    buf >>= k;
    cnt -= k;
    used += k;
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    drop(k);
    return v;
  }
  void align() { drop((int)(used & 7) ? 8 - (int)(used & 7) : 0); }
  bool overrun() const { return used > 8 * (uint64_t)n; }
};

// ---- canonical Huffman codes, decoded through one table of 2^maxlen ------
struct Huffman {
  std::vector<uint16_t> table;  // (symbol << 4) | length; 0: no code
  int maxlen = 0;

  // zlib's rules: an over-subscribed set is refused; an incomplete one only
  // for the code-length code, or where the longest code has more than 1
  // bit (a single 1-bit code is allowed); no codes at all is allowed (a
  // use of it fails)
  bool build(const uint8_t* lens, int n, bool code_lengths) {
    int count[16] = {0};
    for (int i = 0; i < n; ++i) count[lens[i]]++;
    count[0] = 0;
    maxlen = 0;
    for (int l = 1; l < 16; ++l)
      if (count[l]) maxlen = l;
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return false;
    }
    table.clear();
    if (maxlen == 0) return true;
    if (left > 0 && (code_lengths || maxlen != 1)) return false;
    int next[16] = {0};
    int code = 0;
    for (int l = 1; l < 16; ++l) {
      code = (code + count[l - 1]) << 1;
      next[l] = code;
    }
    table.assign((size_t)1 << maxlen, 0);
    for (int sym = 0; sym < n; ++sym) {
      int len = lens[sym];
      if (!len) continue;
      int c = next[len]++;
      int r = 0;
      for (int b = 0; b < len; ++b) r |= ((c >> b) & 1) << (len - 1 - b);
      for (size_t j = r; j < table.size(); j += (size_t)1 << len)
        table[j] = (uint16_t)((sym << 4) | len);
    }
    return true;
  }

  int decode(Bits& br) const {
    if (maxlen == 0) return -1;
    uint16_t e = table[br.peek(maxlen)];
    if (!e) return -1;
    br.drop(e & 15);
    return e >> 4;
  }
};

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,
                                13,   17,   25,   33,   49,   65,    97,
                                129,  193,  257,  385,  513,  769,   1025,
                                1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                              11, 4,  12, 3, 13, 2, 14, 1, 15};

bool inflate_codes(Bits& br, const Huffman& lit, const Huffman& dist,
                   std::vector<uint8_t>& out, size_t limit) {
  for (;;) {
    if (br.overrun()) return false;
    int sym = lit.decode(br);
    if (sym < 0) return false;
    if (sym < 256) {
      if (out.size() >= limit) return false;
      out.push_back((uint8_t)sym);
    } else if (sym == 256) {
      return !br.overrun();
    } else {
      sym -= 257;
      if (sym >= 29) return false;  // 286, 287
      size_t len = kLenBase[sym] + br.get(kLenExtra[sym]);
      int ds = dist.decode(br);
      if (ds < 0 || ds >= 30) return false;  // 30, 31
      size_t d = kDistBase[ds] + br.get(kDistExtra[ds]);
      if (d > out.size() || out.size() + len > limit) return false;
      size_t from = out.size() - d;
      for (size_t i = 0; i < len; ++i) out.push_back(out[from + i]);
    }
  }
}

bool inflate_dynamic(Bits& br, Huffman& lit, Huffman& dist) {
  int nlen = (int)br.get(5) + 257;
  int ndist = (int)br.get(5) + 1;
  int ncode = (int)br.get(4) + 4;
  if (nlen > 286 || ndist > 30) return false;
  uint8_t cl[19] = {0};
  for (int i = 0; i < ncode; ++i) cl[kClOrder[i]] = (uint8_t)br.get(3);
  Huffman clh;
  if (!clh.build(cl, 19, true) || clh.maxlen == 0) return false;
  uint8_t lens[286 + 30] = {0};
  int i = 0;
  while (i < nlen + ndist) {
    if (br.overrun()) return false;
    int sym = clh.decode(br);
    if (sym < 0) return false;
    if (sym < 16) {
      lens[i++] = (uint8_t)sym;
      continue;
    }
    int rep;
    uint8_t val = 0;
    if (sym == 16) {
      if (i == 0) return false;
      val = lens[i - 1];
      rep = 3 + (int)br.get(2);
    } else if (sym == 17) {
      rep = 3 + (int)br.get(3);
    } else {
      rep = 11 + (int)br.get(7);
    }
    if (i + rep > nlen + ndist) return false;
    while (rep--) lens[i++] = val;
  }
  if (lens[256] == 0) return false;  // no end-of-block code
  return lit.build(lens, nlen, false) && dist.build(lens + nlen, ndist, false);
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;  // no overflow before the modulo
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

uint32_t crc32(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool init = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)init;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

uint16_t be16(const uint8_t* p) { return (uint16_t)((p[0] << 8) | p[1]); }

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Reverses the filter of one row in place; `prev` is the previous row of the
// same pass, unfiltered (zeros for the first).
bool unfilter(uint8_t* cur, const uint8_t* prev, size_t len, size_t bpp, int type) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < len; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < len; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < len; ++i) {
        int left = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = (uint8_t)(cur[i] + ((left + prev[i]) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < len; ++i) {
        int left = i >= bpp ? cur[i - bpp] : 0;
        int ul = i >= bpp ? prev[i - bpp] : 0;
        cur[i] = (uint8_t)(cur[i] + paeth(left, prev[i], ul));
      }
      return true;
    default:
      return false;
  }
}

const int kAdam7[7][4] = {  // x0, y0, dx, dy
    {0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
    {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

}  // namespace

bool inflate_zlib(const uint8_t* data, size_t size, std::vector<uint8_t>& out,
                  size_t limit) {
  out.clear();
  if (size < 2) return false;
  uint8_t cmf = data[0], flg = data[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0) return false;
  if (flg & 0x20) return false;  // FDICT: a preset dictionary, which PNG never uses
  Bits br(data + 2, size - 2);
  Huffman lit, dist;
  int final_block = 0;
  while (!final_block) {
    final_block = (int)br.get(1);
    int type = (int)br.get(2);
    if (type == 0) {
      br.align();
      uint32_t len = br.get(16);
      uint32_t nlen = br.get(16);
      if (br.overrun() || len != (~nlen & 0xFFFF)) return false;
      if (out.size() + len > limit) return false;
      for (uint32_t i = 0; i < len; ++i) out.push_back((uint8_t)br.get(8));
      if (br.overrun()) return false;
    } else if (type == 1) {
      uint8_t lens[288 + 32];
      for (int i = 0; i < 144; ++i) lens[i] = 8;
      for (int i = 144; i < 256; ++i) lens[i] = 9;
      for (int i = 256; i < 280; ++i) lens[i] = 7;
      for (int i = 280; i < 288; ++i) lens[i] = 8;
      for (int i = 288; i < 320; ++i) lens[i] = 5;
      if (!lit.build(lens, 288, false) || !dist.build(lens + 288, 32, false)) return false;
      if (!inflate_codes(br, lit, dist, out, limit)) return false;
    } else if (type == 2) {
      if (!inflate_dynamic(br, lit, dist)) return false;
      if (!inflate_codes(br, lit, dist, out, limit)) return false;
    } else {
      return false;
    }
  }
  br.align();
  uint32_t want = 0;
  for (int i = 0; i < 4; ++i) want = (want << 8) | br.get(8);
  return !br.overrun() && want == adler32(out.data(), out.size());
}

bool decode_memory(const uint8_t* d, size_t n, std::vector<uint16_t>& out, int& w,
                   int& h, int& channels, int& bit_depth) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (n < 8 || std::memcmp(d, kSig, 8) != 0) return false;
  size_t pos = 8;
  bool have_ihdr = false, seen_idat = false;
  uint32_t W = 0, H = 0;
  int bd = 0, ct = 0, interlace = 0;
  std::vector<uint8_t> idat, palette;  // palette: RGB triples
  std::vector<uint8_t> trns_alpha;     // palette alpha
  bool has_trns = false;
  uint16_t trns[3] = {0, 0, 0};        // gray, or R G B
  while (pos + 12 <= n) {
    uint32_t len = be32(d + pos);
    if (len > 0x7FFFFFFFu || len > n - pos - 12) return false;  // truncated
    const uint8_t* type = d + pos + 4;
    const uint8_t* data = d + pos + 8;
    bool critical = !(type[0] & 0x20);
    size_t next = pos + 12 + len;
    if (crc32(type, len + 4) != be32(data + len)) {
      if (critical) return false;
      pos = next;  // a damaged ancillary chunk is dropped, as libpng does
      continue;
    }
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (have_ihdr || len != 13) return false;
      W = be32(data);
      H = be32(data + 4);
      bd = data[8];
      ct = data[9];
      interlace = data[12];
      if (W == 0 || H == 0 || W > 1000000 || H > 1000000) return false;  // libpng's limits
      if ((uint64_t)W * H > (1ull << 28)) return false;
      if (data[10] != 0 || data[11] != 0 || interlace > 1) return false;
      bool ok_depth = (ct == 0 && (bd == 1 || bd == 2 || bd == 4 || bd == 8 || bd == 16)) ||
                      (ct == 3 && (bd == 1 || bd == 2 || bd == 4 || bd == 8)) ||
                      ((ct == 2 || ct == 4 || ct == 6) && (bd == 8 || bd == 16));
      if (!ok_depth) return false;
      have_ihdr = true;
    } else if (!have_ihdr) {
      return false;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len == 0 || len > 768) return false;
      if (!seen_idat) palette.assign(data, data + len);
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      if (!seen_idat) {
        if (ct == 0 && len >= 2) {
          trns[0] = be16(data);
          has_trns = true;
        } else if (ct == 2 && len >= 6) {
          for (int k = 0; k < 3; ++k) trns[k] = be16(data + 2 * k);
          has_trns = true;
        } else if (ct == 3 && len > 0 && len <= 256) {
          trns_alpha.assign(data, data + len);
          has_trns = true;
        }
      }
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
      seen_idat = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      return false;  // an unknown critical chunk
    }
    pos = next;
  }
  if (!have_ihdr || !seen_idat) return false;
  if (ct == 3 && palette.empty()) return false;

  const int in_ch = ct == 0 ? 1 : ct == 2 ? 3 : ct == 3 ? 1 : ct == 4 ? 2 : 4;
  const size_t bits_pp = (size_t)in_ch * bd;
  const size_t bpp = bits_pp >= 8 ? bits_pp / 8 : 1;
  auto rowbytes = [&](size_t pw) { return (pw * bits_pp + 7) / 8; };
  struct Pass {
    size_t x0, y0, dx, dy, pw, ph;
  };
  std::vector<Pass> passes;
  for (int p = 0; p < (interlace ? 7 : 1); ++p) {
    size_t x0 = interlace ? kAdam7[p][0] : 0, y0 = interlace ? kAdam7[p][1] : 0;
    size_t dx = interlace ? kAdam7[p][2] : 1, dy = interlace ? kAdam7[p][3] : 1;
    size_t pw = W > x0 ? (W - x0 + dx - 1) / dx : 0;
    size_t ph = H > y0 ? (H - y0 + dy - 1) / dy : 0;
    if (pw && ph) passes.push_back({x0, y0, dx, dy, pw, ph});  // an empty pass has no rows
  }
  size_t expected = 0;
  for (const Pass& ps : passes) expected += ps.ph * (1 + rowbytes(ps.pw));
  std::vector<uint8_t> raw;
  // a stream longer than the image is decoded (libpng warns and goes on),
  // within a bound
  if (!inflate_zlib(idat.data(), idat.size(), raw, 2 * expected + 65536)) return false;
  if (raw.size() < expected) return false;

  const bool expand_trns = has_trns && ct != 4 && ct != 6;
  channels = ct == 3 ? (expand_trns ? 4 : 3) : (expand_trns ? in_ch + 1 : in_ch);
  bit_depth = bd == 16 ? 16 : 8;
  const uint32_t maxval = bd == 16 ? 65535 : 255;
  w = (int)W;
  h = (int)H;
  out.assign((size_t)W * H * channels, 0);

  size_t off = 0;
  std::vector<uint8_t> zero;
  for (const Pass& ps : passes) {
    const size_t rb = rowbytes(ps.pw);
    zero.assign(rb, 0);
    const uint8_t* prev = zero.data();
    for (size_t y = 0; y < ps.ph; ++y) {
      uint8_t* row = raw.data() + off + 1;
      if (!unfilter(row, prev, rb, bpp, raw[off])) return false;
      prev = row;
      off += 1 + rb;
      uint16_t* dst_row = out.data() + ((ps.y0 + y * ps.dy) * W) * channels;
      for (size_t x = 0; x < ps.pw; ++x) {
        uint16_t* dst = dst_row + (ps.x0 + x * ps.dx) * channels;
        uint32_t s[4];
        for (int k = 0; k < in_ch; ++k) {
          if (bd == 16) {
            s[k] = be16(row + 2 * (x * in_ch + k));
          } else if (bd == 8) {
            s[k] = row[x * in_ch + k];
          } else {
            size_t bit = x * bd;
            s[k] = (row[bit >> 3] >> (8 - bd - (bit & 7))) & ((1u << bd) - 1);
          }
        }
        if (ct == 3) {
          size_t idx = s[0];
          bool in_pal = idx * 3 < palette.size();
          for (int k = 0; k < 3; ++k) dst[k] = in_pal ? palette[idx * 3 + k] : 0;
          if (expand_trns) dst[3] = idx < trns_alpha.size() ? trns_alpha[idx] : 255;
          continue;
        }
        for (int k = 0; k < in_ch; ++k)
          dst[k] = (uint16_t)(bd < 8 ? s[k] * (255u / ((1u << bd) - 1)) : s[k]);
        if (expand_trns) {
          bool clear = ct == 0 ? s[0] == trns[0]
                               : (s[0] == trns[0] && s[1] == trns[1] && s[2] == trns[2]);
          dst[in_ch] = (uint16_t)(clear ? 0 : maxval);
        }
      }
    }
  }
  return true;
}

bool decode_file(const std::string& path, std::vector<uint16_t>& out, int& w, int& h,
                 int& channels, int& bit_depth) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  std::vector<uint8_t> bytes;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), fp)) > 0)
    bytes.insert(bytes.end(), chunk, chunk + got);
  bool read_error = std::ferror(fp) != 0;
  std::fclose(fp);
  if (read_error) return false;
  return decode_memory(bytes.data(), bytes.size(), out, w, h, channels, bit_depth);
}

}  // namespace plslam_png
