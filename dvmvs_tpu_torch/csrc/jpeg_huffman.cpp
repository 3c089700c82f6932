// Entropy decoding of one baseline (sequential, Huffman-coded) JPEG scan into
// quantised DCT coefficients, for dvmvs_tpu_torch/data/jpeg.py, which parses
// the markers and does dequantisation, the inverse DCT, upsampling and colour
// conversion in NumPy. Host code with a plain C interface, loaded by ctypes.
//
// What a scan decodes to: for each of its components, blocks of 64 int16
// coefficients in natural (row-major) order, written into that component's
// coefficient plane at (block row, block column). An interleaved scan visits
// MCUs of h x v blocks per component; a scan of one component visits its
// blocks one by one. Restart markers (DRI) reset the DC predictions. As
// libjpeg does, a marker met inside the entropy-coded data ends it and the
// missing bits read as zeros, and a run past the 63rd coefficient writes to
// the last one.

#include <cstdint>
#include <cstring>

namespace {

// position k of the zigzag scan -> natural index, padded as libjpeg's
// jpeg_natural_order so that a corrupt run past 63 stays in the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Table {
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valptr[17];   // index in vals of the first code of each length
  int32_t mincode[17];
  uint8_t vals[256];
};

// Canonical Huffman decoding tables from the DHT counts (bits[1..16]) and
// symbols; returns false when the counts overflow a length's code space.
bool build_table(const uint8_t* bits, const uint8_t* vals, Table* t) {
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  if (total > 256) return false;
  std::memcpy(t->vals, vals, total);
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valptr[l] = k;
      t->mincode[l] = code;
      code += bits[l];
      k += bits[l];
      t->maxcode[l] = code - 1;
      if (code - 1 >= (1 << l)) return false;
    } else {
      t->maxcode[l] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;  // stops a search that found no code
  return true;
}

struct Reader {
  const uint8_t* data;
  int64_t len;
  int64_t pos;     // next byte to read
  uint32_t buf;    // bits not yet used, most significant first
  int nbits;
  bool at_marker;  // a marker ends the entropy-coded data: zeros from here

  int bit() {
    if (nbits == 0) fill();
    --nbits;
    return (buf >> nbits) & 1;
  }

  void fill() {
    uint32_t byte = 0;
    if (!at_marker && pos < len) {
      byte = data[pos];
      if (byte == 0xFF) {
        int64_t next = pos + 1;
        while (next < len && data[next] == 0xFF) ++next;  // fill bytes
        if (next < len && data[next] == 0x00) {
          pos = next + 1;  // a stuffed 0xFF
        } else {
          at_marker = true;
          byte = 0;
        }
      } else {
        ++pos;
      }
    }
    buf = byte;
    nbits = 8;
  }

  int bits(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }

  // the symbol of the next code; -1 for a code no table holds
  int decode(const Table& t) {
    int32_t code = bit();
    int l = 1;
    while (code > t.maxcode[l]) {
      if (l == 16) return -1;
      code = (code << 1) | bit();
      ++l;
    }
    return t.vals[t.valptr[l] + code - t.mincode[l]];
  }

  // drop the rest of the byte and read the RSTn marker that must follow
  bool restart(int expect) {
    nbits = 0;
    at_marker = false;
    while (pos < len && data[pos] == 0xFF) ++pos;
    if (pos >= len || data[pos] != 0xD0 + expect) return false;
    ++pos;
    return true;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

}  // namespace

extern "C" {

// Decode one scan. data[0..len) is the file, the scan's entropy-coded data
// starts at `start`. The scan has n_comp components; component c uses DC
// table dc[c] and AC table ac[c] of the 4 + 4 tables given by bits (8 x 17
// counts, index 0 unused) and vals (8 x 256 symbols, DC tables first), has
// h[c] x v[c] blocks an MCU (1 x 1 in a scan of one component), and its
// plane coef[c] holds rows of stride[c] blocks of 64 coefficients. The scan
// is mcus_x x mcus_y MCUs, with a restart marker every `restart` MCUs (0:
// none). Returns the offset after the last byte read (the next marker starts
// at or after it), or a negative error: -1 a bad table, -2 a code no table
// holds, -3 a missing or misnumbered restart marker.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, int64_t start, int n_comp,
                         const int32_t* dc, const int32_t* ac, const uint8_t* bits,
                         const uint8_t* vals, const int32_t* h, const int32_t* v,
                         const int64_t* stride, int16_t** coef, int64_t mcus_x,
                         int64_t mcus_y, int64_t restart) {
  Table tables[8];
  for (int i = 0; i < 8; ++i) {
    if (!build_table(bits + 17 * i, vals + 256 * i, &tables[i])) return -1;
  }
  Reader r{data, len, start, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  int64_t to_go = restart;
  int next_rst = 0;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart > 0) {
        if (to_go == 0) {
          if (!r.restart(next_rst)) return -3;
          next_rst = (next_rst + 1) & 7;
          to_go = restart;
          std::memset(pred, 0, sizeof(pred));
        }
        --to_go;
      }
      for (int c = 0; c < n_comp; ++c) {
        const Table& tdc = tables[dc[c]];
        const Table& tac = tables[4 + ac[c]];
        for (int by = 0; by < v[c]; ++by) {
          for (int bx = 0; bx < h[c]; ++bx) {
            int16_t* block = coef[c] + ((my * v[c] + by) * stride[c] + mx * h[c] + bx) * 64;
            int s = r.decode(tdc);
            if (s < 0) return -2;
            int diff = s ? extend(r.bits(s), s) : 0;
            pred[c] += diff;
            block[0] = static_cast<int16_t>(pred[c]);
            for (int k = 1; k < 64; ++k) {
              int rs = r.decode(tac);
              if (rs < 0) return -2;
              int run = rs >> 4, size = rs & 15;
              if (size) {
                k += run;
                block[kNatural[k]] = static_cast<int16_t>(extend(r.bits(size), size));
              } else if (run == 15) {
                k += 15;
              } else {
                break;
              }
            }
          }
        }
      }
    }
  }
  return r.pos;
}

}  // extern "C"
