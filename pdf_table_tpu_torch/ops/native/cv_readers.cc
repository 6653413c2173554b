// The loops of OpenCV 5.0.0's readers that utils/cv_readers.py calls
// through ctypes, held to cv2 5.0.0 by tests/test_torch_image_formats.py.
//
// cvr_pxm_numbers: PxMDecoder's ReadNumber (modules/imgcodecs/src/
// grfmt_pxm.cpp), n times, for the PNM header and its ASCII samples:
//
// - white space and comments (from '#' to a CR or LF) are skipped before
//   a number; any other byte there fails;
// - a number is its decimal digits; the byte after them is consumed
//   whatever it is, except where one digit is a whole number (P1);
// - a value over INT_MAX fails, and so does the end of the data wherever
//   a byte is still to be read.
//
// cvg_lzw_decode: the GIF LZW decoder (grfmt_gif.cpp,
// GifDecoder::lzwDecode):
//
// - codes are read LSB first, one byte taken whenever fewer bits are left
//   than the code size, across the data sub-blocks;
// - the table entry after the last one is pending: a code completes it
//   (its suffix is the first byte of the code's string) and opens the
//   next one with the code's string as its prefix. A code past the
//   pending entry fails the decode;
// - the code size grows when the pending entry reaches 1 << size, up to
//   12 bits; once the table holds 4096 entries it stops growing and codes
//   are still output (a "deferred clear");
// - a string that would run past the frame's pixels fails (CV_Assert in
//   OpenCV), and so does a single pixel past them;
// - the end-of-information code ends the codes of the sub-block (the rest
//   of it is read on as codes), and the decode ends at the terminator.
#include <cstdint>

namespace {

enum Status : int32_t {
  // both loops
  kOk = 0,
  kEnd = 3,          // the data ran out
  // cvr_pxm_numbers
  kUnexpected = 1,   // a byte other than a digit, white space or '#'
  kTooLarge = 2,     // a number over INT_MAX
  // cvg_lzw_decode
  kBadCode = 1,      // a code past the pending entry
  kOverrun = 2,      // a string past the frame's pixels
  kCodeSize = 4,     // a minimum code size outside 2..11
};

struct Reader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;
  bool get(uint8_t* v) {
    if (pos >= size) return false;
    *v = data[pos++];
    return true;
  }
};

bool is_space(uint8_t c) {
  return c == ' ' || (c >= '\t' && c <= '\r');
}

bool is_digit(uint8_t c) { return c >= '0' && c <= '9'; }

}  // namespace

extern "C" int32_t cvr_pxm_numbers(const uint8_t* data, int64_t size,
                                   int64_t pos, int64_t n, int32_t one_digit,
                                   int32_t* out, int64_t* end_pos) {
  Reader in{data, size, pos};
  for (int64_t i = 0; i < n; ++i) {
    uint8_t c;
    if (!in.get(&c)) return kEnd;
    while (!is_digit(c)) {
      if (c == '#') {
        do {
          if (!in.get(&c)) return kEnd;
        } while (c != '\n' && c != '\r');
        if (!in.get(&c)) return kEnd;
      } else if (is_space(c)) {
        while (is_space(c)) {
          if (!in.get(&c)) return kEnd;
        }
      } else {
        return kUnexpected;
      }
    }
    int64_t val = 0;
    for (;;) {
      val = val * 10 + (c - '0');
      if (val > INT32_MAX) return kTooLarge;
      if (one_digit) break;
      if (!in.get(&c)) return kEnd;
      if (!is_digit(c)) break;
    }
    out[i] = int32_t(val);
  }
  *end_pos = in.pos;
  return kOk;
}

extern "C" int32_t cvg_lzw_decode(const uint8_t* data, int64_t size,
                                  int64_t pos, int64_t npix, uint8_t* out,
                                  int64_t* written) {
  constexpr int kMaxSize = 1 << 12;
  Reader in{data, size, pos};
  *written = 0;
  uint8_t min_size;
  if (!in.get(&min_size)) return kEnd;
  int code_size = min_size + 1;
  if (!(code_size > 2 && code_size <= 12)) return kCodeSize;
  const int clear = 1 << min_size, exit_code = clear + 1;
  // entry e: its string is string(parent[e]) + suffix[e]; a literal is
  // its own string
  static thread_local int32_t parent[kMaxSize + 1];
  static thread_local uint8_t suffix[kMaxSize + 1], first[kMaxSize + 1];
  static thread_local int32_t length[kMaxSize + 1];
  int table = exit_code;                 // the pending entry
  int64_t idx = 0;
  int left = 0;
  uint32_t src = 0;
  uint8_t block;
  if (!in.get(&block)) return kEnd;
  while (block) {
    if (left < code_size) {
      uint8_t b;
      if (!in.get(&b)) return kEnd;
      src |= uint32_t(b) << left;
      --block;
      left += 8;
    }
    while (left >= code_size) {
      const int code = int(src & ((1u << code_size) - 1));
      src >>= code_size;
      left -= code_size;
      if (code == clear) {
        code_size = min_size + 1;
        table = exit_code;
        continue;
      }
      if (code == exit_code) {
        code_size = min_size + 1;
        table = exit_code;
        break;
      }
      const bool full = table >= kMaxSize;
      if (code < clear) {
        if (!full) {
          suffix[table] = uint8_t(code);
          ++table;
          parent[table] = code;
          first[table] = uint8_t(code);
          length[table] = 2;
        }
        if (idx + 1 > npix) return kOverrun;
        out[idx++] = uint8_t(code);
      } else if (code <= table) {
        if (!full) {
          suffix[table] = first[code];
          ++table;
          parent[table] = code;
          first[table] = first[code];
          length[table] = length[code] + 1;
        }
        const int64_t n = length[code];
        if (idx + n > npix) return kOverrun;
        int64_t at = idx + n - 1;
        int c = code;
        while (c >= clear) {
          out[at--] = suffix[c];
          c = parent[c];
        }
        out[at] = uint8_t(c);
        idx += n;
      } else {
        return kBadCode;
      }
      if (table == (1 << code_size) && code_size < 12) ++code_size;
    }
    if (!block && !in.get(&block)) return kEnd;
  }
  *written = idx;
  return kOk;
}
