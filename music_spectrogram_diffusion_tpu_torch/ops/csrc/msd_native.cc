// Host C++ for the TFRecord reader: record framing with the masked CRC32C
// check, the masked CRC32C itself, and a packed-varint decoder.
//
// A plain C interface, built by g++ at first use and bound with ctypes
// (ops/_build.py), as csrc/pghi_heap.cc is. The Python side is
// data/native.py; data/datasets.py keeps the plain Python versions
// (`_iter_tfrecords_py`, `_read_varint`, `_masked_crc32c`) that the tests
// hold these against.
//
// The functions compute what the JAX package's extension computes
// (native/msd_native.cc masked_crc32c, split_tfrecords, decode_varints):
// the same table CRC32C (Castagnoli), the same masking, the same framing
// and the same error cases.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

uint32_t g_crc_table[256];
bool g_crc_table_init = false;

void init_crc_table() {
  if (g_crc_table_init) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k) crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    g_crc_table[i] = crc;
  }
  g_crc_table_init = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  init_crc_table();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) crc = g_crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked(const uint8_t* data, size_t n) {
  const uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // namespace

extern "C" {

// The error codes of msd_split_tfrecords and msd_decode_varints.
enum {
  kTruncatedRecord = -1,
  kLengthCrcMismatch = -2,
  kDataCrcMismatch = -3,
  kVarintTooLong = -4,
  kTruncatedVarint = -5,
};

uint32_t msd_masked_crc32c(const uint8_t* data, int64_t n) {
  return masked(data, static_cast<size_t>(n));
}

// Splits `n` bytes of TFRecord framing into records. Each record is
// [uint64 length][uint32 masked CRC of the length][data][uint32 masked CRC
// of the data], little-endian. Writes the offset and length of record i
// into offsets[2 i] and offsets[2 i + 1] while i < capacity (so capacity 0
// only counts), and checks both CRCs when `verify` is nonzero. Returns the
// number of records, or a negative error code: a truncated record, or a
// CRC that disagrees.
int64_t msd_split_tfrecords(const uint8_t* data, int64_t n_bytes, int verify,
                            int64_t* offsets, int64_t capacity) {
  const size_t n = static_cast<size_t>(n_bytes);
  size_t pos = 0;
  int64_t count = 0;
  while (pos + 12 <= n) {
    uint64_t length;
    std::memcpy(&length, data + pos, 8);  // little-endian hosts only
    uint32_t stored_length_crc;
    std::memcpy(&stored_length_crc, data + pos + 8, 4);
    if (verify && masked(data + pos, 8) != stored_length_crc) return kLengthCrcMismatch;
    pos += 12;
    // Overflow-safe: a corrupt 64-bit length could wrap pos + length + 4.
    if (length > n - pos || n - pos - length < 4) return kTruncatedRecord;
    if (verify) {
      uint32_t stored_data_crc;
      std::memcpy(&stored_data_crc, data + pos + length, 4);
      if (masked(data + pos, length) != stored_data_crc) return kDataCrcMismatch;
    }
    if (count < capacity) {
      offsets[2 * count] = static_cast<int64_t>(pos);
      offsets[2 * count + 1] = static_cast<int64_t>(length);
    }
    ++count;
    pos += length + 4;
  }
  return count;
}

// Decodes a run of packed base-128 varints (protobuf's packed Int64List)
// into `out`, which holds `capacity` values (n_bytes is always enough: a
// varint takes at least one byte). Returns the count, or a negative error
// code: a varint of more than 10 bytes, or one the buffer cuts short.
int64_t msd_decode_varints(const uint8_t* data, int64_t n_bytes, uint64_t* out,
                           int64_t capacity) {
  const size_t n = static_cast<size_t>(n_bytes);
  size_t pos = 0;
  int64_t count = 0;
  while (pos < n) {
    uint64_t v = 0;
    int shift = 0;
    bool terminated = false;
    while (pos < n) {
      const uint8_t b = data[pos++];
      if (shift >= 64) return kVarintTooLong;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) {
        terminated = true;
        break;
      }
      shift += 7;
    }
    if (!terminated) return kTruncatedVarint;
    if (count < capacity) out[count] = v;
    ++count;
  }
  return count;
}

}  // extern "C"
