// TFRecord framing codec: CRC32C + record frame/parse, exposed via a C ABI
// for the Python ctypes wrapper (tensorflowonspark_tpu_torch/tfrecord.py).
// The port's own copy of tensorflowonspark_tpu/native/tfrecord.cc.
//
// The reference gets TFRecord IO from the JVM tensorflow-hadoop JAR
// (dfutil.py -> saveAsNewAPIHadoopFile with TFRecordFileOutputFormat) and the
// TF C++ runtime; this is the rebuild's native equivalent (SURVEY.md §2b
// "TFRecord on HDFS from JVM"), JVM-free.  The hot loop — CRC32C over every
// record body — is the part worth doing natively; file IO stays in Python.
//
// Format (TFRecord on-disk framing):
//   uint64le length
//   uint32le masked_crc32c(length bytes)
//   byte     data[length]
//   uint32le masked_crc32c(data)
//
// CRC32C uses the Castagnoli polynomial (reversed 0x82F63B78), slice-by-8
// tables for ~1 byte/cycle without SSE4.2 intrinsics (portable across the
// build hosts).  mask(crc) = ((crc >> 15) | (crc << 17)) + 0xa282ead8.

#include <cstdint>
#include <cstddef>
#include <cstring>

namespace {

uint32_t kTable[8][256];
bool kInit = false;

void init_tables() {
  if (kInit) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      kTable[t][i] = (kTable[t - 1][i] >> 8) ^ kTable[0][kTable[t - 1][i] & 0xFF];
  kInit = true;
}

inline uint32_t crc32c_impl(uint32_t crc, const uint8_t* p, size_t n) {
  crc = ~crc;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= crc;  // little-endian assumption (x86/arm64, matches the fleet)
    crc = kTable[7][w & 0xFF] ^ kTable[6][(w >> 8) & 0xFF] ^
          kTable[5][(w >> 16) & 0xFF] ^ kTable[4][(w >> 24) & 0xFF] ^
          kTable[3][(w >> 32) & 0xFF] ^ kTable[2][(w >> 40) & 0xFF] ^
          kTable[1][(w >> 48) & 0xFF] ^ kTable[0][(w >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kTable[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

inline uint32_t mask_crc(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

inline void put_u32(uint8_t* out, uint32_t v) {
  out[0] = v & 0xFF; out[1] = (v >> 8) & 0xFF;
  out[2] = (v >> 16) & 0xFF; out[3] = (v >> 24) & 0xFF;
}

inline uint32_t get_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
         ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

inline uint64_t get_u64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

}  // namespace

extern "C" {

uint32_t tfr_crc32c(const uint8_t* data, size_t n) {
  init_tables();
  return crc32c_impl(0, data, n);
}

uint32_t tfr_masked_crc(const uint8_t* data, size_t n) {
  init_tables();
  return mask_crc(crc32c_impl(0, data, n));
}

// Frame one record: writes length+lencrc+data+datacrc into out (caller
// allocates n+16 bytes).  Returns bytes written.
size_t tfr_frame(const uint8_t* data, size_t n, uint8_t* out) {
  init_tables();
  uint8_t len_le[8];
  uint64_t len = n;
  for (int i = 0; i < 8; ++i) { len_le[i] = len & 0xFF; len >>= 8; }
  std::memcpy(out, len_le, 8);
  put_u32(out + 8, mask_crc(crc32c_impl(0, len_le, 8)));
  std::memcpy(out + 12, data, n);
  put_u32(out + 12 + n, mask_crc(crc32c_impl(0, data, n)));
  return n + 16;
}

// Parse the record starting at buf+off.  Sets *data_off/*data_len and
// returns the offset of the next record.  Returns -1 at clean EOF
// (off == buflen), -2 on truncation, -3 on length-crc mismatch, -4 on
// data-crc mismatch (crc checks only when verify != 0).
int64_t tfr_next(const uint8_t* buf, size_t buflen, size_t off,
                 size_t* data_off, size_t* data_len, int verify) {
  init_tables();
  if (off == buflen) return -1;
  if (off + 12 > buflen) return -2;
  uint64_t len = get_u64(buf + off);
  if (verify &&
      get_u32(buf + off + 8) != mask_crc(crc32c_impl(0, buf + off, 8)))
    return -3;
  // overflow-safe: a corrupt length near UINT64_MAX must not wrap past buflen
  if (off + 16 > buflen || len > buflen - (off + 16)) return -2;
  if (verify &&
      get_u32(buf + off + 12 + len) !=
          mask_crc(crc32c_impl(0, buf + off + 12, len)))
    return -4;
  *data_off = off + 12;
  *data_len = len;
  return (int64_t)(off + 16 + len);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// tf.train.Example decoder (the loadTFRecords/fromTFExample hot path —
// reference: the tensorflow-hadoop JAR's JVM-side parsing, SURVEY.md §2b).
// Python's per-varint loop parses ~2.6k records/s; this parser is the
// native replacement behind example_proto.decode_example.
//
// Wire shapes handled (mirrors example_proto.py exactly):
//   Example{ features=1: Features{ feature=1(map entry){ key=1, value=2:
//     Feature{ bytes_list=1 | float_list=2 | int64_list=3 } } } }
//   *List.value = field 1, packed OR unpacked.
// ---------------------------------------------------------------------------

namespace {

// varint; returns new pos or -1 on truncation/overlong
inline int64_t read_varint(const uint8_t* b, int64_t pos, int64_t end,
                           uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (pos < end && shift <= 63) {
    uint8_t byte = b[pos++];
    v |= (uint64_t)(byte & 0x7F) << shift;
    if (!(byte & 0x80)) { *out = v; return pos; }
    shift += 7;
  }
  return -1;
}

inline int64_t skip_field(const uint8_t* b, int64_t pos, int64_t end,
                          uint32_t wire) {
  uint64_t tmp;
  switch (wire) {
    case 0: return read_varint(b, pos, end, &tmp);
    case 1: return pos + 8 <= end ? pos + 8 : -1;
    case 2: {
      int64_t p = read_varint(b, pos, end, &tmp);
      if (p < 0 || tmp > (uint64_t)(end - p)) return -1;
      return p + (int64_t)tmp;
    }
    case 5: return pos + 4 <= end ? pos + 4 : -1;
    default: return -1;
  }
}

// count elements in a *List message body [pos, end): field 1 packed/unpacked
inline int64_t count_list(const uint8_t* b, int64_t pos, int64_t end,
                          int kind /*0 bytes,1 float,2 int64*/) {
  int64_t count = 0;
  uint64_t tmp;
  while (pos < end) {
    uint64_t tag;
    pos = read_varint(b, pos, end, &tag);
    if (pos < 0) return -1;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {           // length-delimited
      uint64_t n;
      pos = read_varint(b, pos, end, &n);
      if (pos < 0 || n > (uint64_t)(end - pos)) return -1;
      if (kind == 0) {
        count += 1;                          // one bytes value
      } else if (kind == 1) {
        count += (int64_t)(n / 4);           // packed floats
      } else {                               // packed varints
        int64_t p = pos, pend = pos + (int64_t)n;
        while (p < pend) {
          p = read_varint(b, p, pend, &tmp);
          if (p < 0) return -1;
          ++count;
        }
      }
      pos += (int64_t)n;
    } else if (field == 1 && wire == 5 && kind == 1) {
      count += 1; pos += 4;                  // unpacked float
      if (pos > end) return -1;
    } else if (field == 1 && wire == 0 && kind == 2) {
      pos = read_varint(b, pos, end, &tmp);  // unpacked int64
      if (pos < 0) return -1;
      ++count;
    } else {
      pos = skip_field(b, pos, end, wire);
      if (pos < 0) return -1;
    }
  }
  return count;
}

}  // namespace

extern "C" {

// Scan an Example. meta rows of 6 int64s per feature:
//   {name_off, name_len, kind(0/1/2), count, payload_off, payload_len}
// offsets into buf; payload is the *List message body.  Returns the number
// of features (even if > max_feats — caller re-calls with a bigger meta),
// or -1 on malformed input.
int64_t exp_scan(const uint8_t* buf, size_t buflen, int64_t* meta,
                 int64_t max_feats) {
  int64_t n_feats = 0;
  int64_t pos = 0, end = (int64_t)buflen;
  while (pos < end) {
    uint64_t tag;
    pos = read_varint(buf, pos, end, &tag);
    if (pos < 0) return -1;
    if ((tag >> 3) == 1 && (tag & 7) == 2) {          // Example.features
      uint64_t flen;
      pos = read_varint(buf, pos, end, &flen);
      if (pos < 0 || flen > (uint64_t)(end - pos)) return -1;
      int64_t fpos = pos, fend = pos + (int64_t)flen;
      pos = fend;
      while (fpos < fend) {
        uint64_t ftag;
        fpos = read_varint(buf, fpos, fend, &ftag);
        if (fpos < 0) return -1;
        if ((ftag >> 3) != 1 || (ftag & 7) != 2) {
          fpos = skip_field(buf, fpos, fend, ftag & 7);
          if (fpos < 0) return -1;
          continue;
        }
        uint64_t elen;                                 // map entry
        fpos = read_varint(buf, fpos, fend, &elen);
        if (fpos < 0 || elen > (uint64_t)(fend - fpos)) return -1;
        int64_t epos = fpos, eend = fpos + (int64_t)elen;
        fpos = eend;
        int64_t name_off = -1, name_len = 0;
        int64_t kind = 0, count = 0, pay_off = 0, pay_len = 0;
        while (epos < eend) {
          uint64_t etag;
          epos = read_varint(buf, epos, eend, &etag);
          if (epos < 0) return -1;
          uint32_t efield = etag >> 3, ewire = etag & 7;
          if (ewire != 2) {
            epos = skip_field(buf, epos, eend, ewire);
            if (epos < 0) return -1;
            continue;
          }
          uint64_t vlen;
          epos = read_varint(buf, epos, eend, &vlen);
          if (epos < 0 || vlen > (uint64_t)(eend - epos)) return -1;
          if (efield == 1) {                           // key
            name_off = epos; name_len = (int64_t)vlen;
          } else if (efield == 2) {    // Feature (proto: LAST value wins,
                                       // matching the Python oracle)
            int64_t vpos = epos, vend = epos + (int64_t)vlen;
            while (vpos < vend) {
              uint64_t vtag;
              vpos = read_varint(buf, vpos, vend, &vtag);
              if (vpos < 0) return -1;
              uint32_t vfield = vtag >> 3, vwire = vtag & 7;
              if (vwire != 2 || vfield < 1 || vfield > 3) {
                vpos = skip_field(buf, vpos, vend, vwire);
                if (vpos < 0) return -1;
                continue;
              }
              uint64_t llen;                           // the *List message
              vpos = read_varint(buf, vpos, vend, &llen);
              if (vpos < 0 || llen > (uint64_t)(vend - vpos)) return -1;
              kind = (int64_t)vfield - 1;              // 0/1/2
              pay_off = vpos; pay_len = (int64_t)llen;
              count = count_list(buf, vpos, vpos + (int64_t)llen, (int)kind);
              if (count < 0) return -1;
              break;               // first list within THIS Feature wins
            }
          }
          epos += (int64_t)vlen;
        }
        if (name_off >= 0) {
          if (n_feats < max_feats) {
            int64_t* row = meta + n_feats * 6;
            row[0] = name_off; row[1] = name_len; row[2] = kind;
            row[3] = count; row[4] = pay_off; row[5] = pay_len;
          }
          ++n_feats;
        }
      }
    } else {
      pos = skip_field(buf, pos, end, tag & 7);
      if (pos < 0) return -1;
    }
  }
  return n_feats;
}

// Decode an int64 *List body into out[count].  Returns elements written.
int64_t exp_read_int64(const uint8_t* b, size_t len, int64_t* out,
                       int64_t count) {
  int64_t pos = 0, end = (int64_t)len, w = 0;
  uint64_t tmp;
  while (pos < end && w < count) {
    uint64_t tag;
    pos = read_varint(b, pos, end, &tag);
    if (pos < 0) return -1;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {
      uint64_t n;
      pos = read_varint(b, pos, end, &n);
      if (pos < 0 || n > (uint64_t)(end - pos)) return -1;
      int64_t p = pos, pend = pos + (int64_t)n;
      while (p < pend && w < count) {
        p = read_varint(b, p, pend, &tmp);
        if (p < 0) return -1;
        out[w++] = (int64_t)tmp;
      }
      pos += (int64_t)n;
    } else if (field == 1 && wire == 0) {
      pos = read_varint(b, pos, end, &tmp);
      if (pos < 0) return -1;
      out[w++] = (int64_t)tmp;
    } else {
      pos = skip_field(b, pos, end, wire);
      if (pos < 0) return -1;
    }
  }
  return w;
}

// Decode a float *List body into out[count].
int64_t exp_read_float(const uint8_t* b, size_t len, float* out,
                       int64_t count) {
  int64_t pos = 0, end = (int64_t)len, w = 0;
  while (pos < end && w < count) {
    uint64_t tag;
    pos = read_varint(b, pos, end, &tag);
    if (pos < 0) return -1;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {
      uint64_t n;
      pos = read_varint(b, pos, end, &n);
      if (pos < 0 || n > (uint64_t)(end - pos)) return -1;
      int64_t m = (int64_t)(n / 4);
      if (m > count - w) m = count - w;
      std::memcpy(out + w, b + pos, (size_t)m * 4);
      w += m;
      pos += (int64_t)n;
    } else if (field == 1 && wire == 5) {
      if (pos + 4 > end) return -1;
      std::memcpy(out + w, b + pos, 4);
      ++w; pos += 4;
    } else {
      pos = skip_field(b, pos, end, wire);
      if (pos < 0) return -1;
    }
  }
  return w;
}

// Offsets of bytes values within a bytes *List body: offs[i*2]={off,len}
// relative to the payload pointer.  Returns values written.
int64_t exp_read_bytes(const uint8_t* b, size_t len, int64_t* offs,
                       int64_t count) {
  int64_t pos = 0, end = (int64_t)len, w = 0;
  while (pos < end && w < count) {
    uint64_t tag;
    pos = read_varint(b, pos, end, &tag);
    if (pos < 0) return -1;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {
      uint64_t n;
      pos = read_varint(b, pos, end, &n);
      if (pos < 0 || n > (uint64_t)(end - pos)) return -1;
      offs[w * 2] = pos; offs[w * 2 + 1] = (int64_t)n;
      ++w;
      pos += (int64_t)n;
    } else {
      pos = skip_field(b, pos, end, wire);
      if (pos < 0) return -1;
    }
  }
  return w;
}

}  // extern "C"
