// Wire-format helpers for the protobuf-free message classes that
// torchft_tpu_torch/_protogen.py generates from native/proto/tpuft.proto.
//
// The native coordination plane (native/src) reaches protobuf only through
// "tpuft.pb.h". The generated header gives it the same message API over
// these helpers, so the plane builds with g++ alone, without protobuf's C++
// library, headers or protoc. The bytes follow proto3: fields in number
// order, default scalars not written, negative int32/int64/enum values as
// 10-byte varints, repeated numbers packed, unknown fields skipped on parse.
#pragma once

#include <cstdint>
#include <cstring>
#include <string>

namespace tpuft_pb {

enum WireType : uint32_t { kVarint = 0, kFixed64 = 1, kLengthDelimited = 2, kFixed32 = 5 };

inline void put_varint(std::string* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back(static_cast<char>((v & 0x7F) | 0x80));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

inline void put_tag(std::string* out, uint32_t field, WireType type) {
  put_varint(out, (static_cast<uint64_t>(field) << 3) | type);
}

inline void put_fixed64(std::string* out, uint64_t v) {
  for (int i = 0; i < 8; ++i) out->push_back(static_cast<char>((v >> (8 * i)) & 0xFF));
}

inline void put_fixed32(std::string* out, uint32_t v) {
  for (int i = 0; i < 4; ++i) out->push_back(static_cast<char>((v >> (8 * i)) & 0xFF));
}

inline void put_bytes(std::string* out, uint32_t field, const std::string& bytes) {
  put_tag(out, field, kLengthDelimited);
  put_varint(out, bytes.size());
  out->append(bytes);
}

inline uint64_t double_bits(double v) {
  uint64_t bits;
  std::memcpy(&bits, &v, sizeof bits);
  return bits;
}

inline uint32_t float_bits(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, sizeof bits);
  return bits;
}

inline double bits_double(uint64_t bits) {
  double v;
  std::memcpy(&v, &bits, sizeof v);
  return v;
}

inline float bits_float(uint32_t bits) {
  float v;
  std::memcpy(&v, &bits, sizeof v);
  return v;
}

// A bounded cursor over serialized bytes. Every read checks the bound and
// returns false on malformed input.
struct Reader {
  const uint8_t* p;
  const uint8_t* end;

  bool done() const { return p >= end; }

  bool varint(uint64_t* v) {
    uint64_t result = 0;
    for (int shift = 0; shift < 64; shift += 7) {
      if (p >= end) return false;
      const uint8_t byte = *p++;
      result |= static_cast<uint64_t>(byte & 0x7F) << shift;
      if (!(byte & 0x80)) {
        *v = result;
        return true;
      }
    }
    return false;  // more than 10 bytes
  }

  bool fixed64(uint64_t* v) {
    if (end - p < 8) return false;
    uint64_t result = 0;
    for (int i = 0; i < 8; ++i) result |= static_cast<uint64_t>(p[i]) << (8 * i);
    p += 8;
    *v = result;
    return true;
  }

  bool fixed32(uint32_t* v) {
    if (end - p < 4) return false;
    uint32_t result = 0;
    for (int i = 0; i < 4; ++i) result |= static_cast<uint32_t>(p[i]) << (8 * i);
    p += 4;
    *v = result;
    return true;
  }

  // A length-delimited field's bytes, as a sub-reader.
  bool sub(Reader* out) {
    uint64_t len;
    if (!varint(&len) || len > static_cast<uint64_t>(end - p)) return false;
    *out = Reader{p, p + len};
    p += len;
    return true;
  }

  bool bytes(std::string* out) {
    Reader r{nullptr, nullptr};
    if (!sub(&r)) return false;
    out->assign(reinterpret_cast<const char*>(r.p), r.end - r.p);
    return true;
  }

  // Skips one field of the given wire type (an unknown field, or a known
  // field sent with another wire type, as protobuf itself does).
  bool skip(uint32_t type) {
    uint64_t v;
    uint32_t w;
    Reader r{nullptr, nullptr};
    switch (type) {
      case kVarint: return varint(&v);
      case kFixed64: return fixed64(&v);
      case kLengthDelimited: return sub(&r);
      case kFixed32: return fixed32(&w);
      default: return false;  // groups are not proto3
    }
  }
};

}  // namespace tpuft_pb
