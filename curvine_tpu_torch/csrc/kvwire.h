// The MessagePack subset and the CRC32 of the port's native KV engine
// (kv_engine.cc): the part of the reference's csrc/wire.h (the msgpack
// Value, pack_value, unpack_value, crc32) that the engine uses, without
// the RPC frames. pack_value writes msgpack's smallest encoding for
// every int and length, so a segment trailer packed here is byte-equal
// to the Python engine's (rpc/wirepack.py). Header-only.
#ifndef CURVINE_TORCH_KVWIRE_H
#define CURVINE_TORCH_KVWIRE_H

#include <arpa/inet.h>

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace kvwire {

// ---------------------------------------------------------------- msgpack
struct Value {
  enum Kind { NIL, BOOL, INT, UINT, DBL, STR, BIN, ARR, MAP } kind = NIL;
  bool b = false;
  int64_t i = 0;
  uint64_t u = 0;
  double d = 0;
  std::string s;                      // STR and BIN
  std::vector<Value> arr;
  std::vector<std::pair<std::string, Value>> map;  // string keys only

  int64_t as_int() const {
    if (kind == INT) return i;
    if (kind == UINT) return static_cast<int64_t>(u);
    if (kind == DBL) return static_cast<int64_t>(d);
    return 0;
  }
  bool as_bool() const { return kind == BOOL ? b : as_int() != 0; }
  const Value* get(const std::string& key) const {
    for (auto& kv : map)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
};

inline void pack_value(std::string& out, const Value& v);

inline void pack_uint(std::string& out, uint64_t u) {
  if (u < 128) {
    out.push_back(static_cast<char>(u));
  } else if (u <= 0xFF) {
    out.push_back('\xcc');
    out.push_back(static_cast<char>(u));
  } else if (u <= 0xFFFF) {
    out.push_back('\xcd');
    uint16_t x = htons(static_cast<uint16_t>(u));
    out.append(reinterpret_cast<char*>(&x), 2);
  } else if (u <= 0xFFFFFFFFULL) {
    out.push_back('\xce');
    uint32_t x = htonl(static_cast<uint32_t>(u));
    out.append(reinterpret_cast<char*>(&x), 4);
  } else {
    out.push_back('\xcf');
    for (int s = 56; s >= 0; s -= 8)
      out.push_back(static_cast<char>((u >> s) & 0xFF));
  }
}

inline void pack_int(std::string& out, int64_t i) {
  if (i >= 0) {
    pack_uint(out, static_cast<uint64_t>(i));
    return;
  }
  if (i >= -32) {
    out.push_back(static_cast<char>(i));
  } else if (i >= INT8_MIN) {
    out.push_back('\xd0');
    out.push_back(static_cast<char>(i));
  } else if (i >= INT16_MIN) {
    out.push_back('\xd1');
    uint16_t x = htons(static_cast<uint16_t>(i));
    out.append(reinterpret_cast<char*>(&x), 2);
  } else if (i >= INT32_MIN) {
    out.push_back('\xd2');
    uint32_t x = htonl(static_cast<uint32_t>(i));
    out.append(reinterpret_cast<char*>(&x), 4);
  } else {
    out.push_back('\xd3');
    for (int s = 56; s >= 0; s -= 8)
      out.push_back(static_cast<char>((static_cast<uint64_t>(i) >> s) & 0xFF));
  }
}

inline void pack_str(std::string& out, const std::string& s) {
  size_t n = s.size();
  if (n < 32) {
    out.push_back(static_cast<char>(0xA0 | n));
  } else if (n <= 0xFF) {
    out.push_back('\xd9');
    out.push_back(static_cast<char>(n));
  } else if (n <= 0xFFFF) {
    out.push_back('\xda');
    uint16_t x = htons(static_cast<uint16_t>(n));
    out.append(reinterpret_cast<char*>(&x), 2);
  } else {
    out.push_back('\xdb');
    uint32_t x = htonl(static_cast<uint32_t>(n));
    out.append(reinterpret_cast<char*>(&x), 4);
  }
  out += s;
}

inline void pack_value(std::string& out, const Value& v) {
  switch (v.kind) {
    case Value::NIL: out.push_back('\xc0'); break;
    case Value::BOOL: out.push_back(v.b ? '\xc3' : '\xc2'); break;
    case Value::INT: pack_int(out, v.i); break;
    case Value::UINT: pack_uint(out, v.u); break;
    case Value::DBL: {
      out.push_back('\xcb');
      uint64_t bits;
      memcpy(&bits, &v.d, 8);
      for (int s = 56; s >= 0; s -= 8)
        out.push_back(static_cast<char>((bits >> s) & 0xFF));
      break;
    }
    case Value::STR: pack_str(out, v.s); break;
    case Value::BIN: {
      size_t n = v.s.size();
      if (n <= 0xFF) {
        out.push_back('\xc4');
        out.push_back(static_cast<char>(n));
      } else if (n <= 0xFFFF) {
        out.push_back('\xc5');
        uint16_t x = htons(static_cast<uint16_t>(n));
        out.append(reinterpret_cast<char*>(&x), 2);
      } else {
        out.push_back('\xc6');
        uint32_t x = htonl(static_cast<uint32_t>(n));
        out.append(reinterpret_cast<char*>(&x), 4);
      }
      out += v.s;
      break;
    }
    case Value::ARR: {
      size_t n = v.arr.size();
      if (n < 16) {
        out.push_back(static_cast<char>(0x90 | n));
      } else if (n <= 0xFFFF) {
        out.push_back('\xdc');
        uint16_t x = htons(static_cast<uint16_t>(n));
        out.append(reinterpret_cast<char*>(&x), 2);
      } else {
        // array32: a truncated array16 count would silently corrupt
        // big payloads (e.g. a compacted segment's sparse index past
        // 65,535 entries ≈ 4.2M keys — the whole namespace)
        out.push_back('\xdd');
        uint32_t x = htonl(static_cast<uint32_t>(n));
        out.append(reinterpret_cast<char*>(&x), 4);
      }
      for (auto& e : v.arr) pack_value(out, e);
      break;
    }
    case Value::MAP: {
      size_t n = v.map.size();
      if (n < 16) {
        out.push_back(static_cast<char>(0x80 | n));
      } else if (n <= 0xFFFF) {
        out.push_back('\xde');
        uint16_t x = htons(static_cast<uint16_t>(n));
        out.append(reinterpret_cast<char*>(&x), 2);
      } else {
        out.push_back('\xdf');
        uint32_t x = htonl(static_cast<uint32_t>(n));
        out.append(reinterpret_cast<char*>(&x), 4);
      }
      for (auto& kv : v.map) {
        pack_str(out, kv.first);
        pack_value(out, kv.second);
      }
      break;
    }
  }
}

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  uint8_t u8() {
    if (off >= n) throw std::runtime_error("msgpack: truncated");
    return p[off++];
  }
  uint64_t be(int bytes) {
    uint64_t v = 0;
    for (int i = 0; i < bytes; i++) v = (v << 8) | u8();
    return v;
  }
  std::string bytes(size_t k) {
    if (off + k > n) throw std::runtime_error("msgpack: truncated str");
    std::string s(reinterpret_cast<const char*>(p + off), k);
    off += k;
    return s;
  }
};

inline Value unpack_value(Cursor& c) {
  Value v;
  uint8_t t = c.u8();
  if (t < 0x80) { v.kind = Value::UINT; v.u = t; return v; }
  if (t >= 0xE0) { v.kind = Value::INT; v.i = static_cast<int8_t>(t); return v; }
  if ((t & 0xF0) == 0x80 || t == 0xDE || t == 0xDF) {   // map
    size_t n = (t & 0xF0) == 0x80 ? (t & 0x0F)
               : (t == 0xDE ? c.be(2) : c.be(4));
    v.kind = Value::MAP;
    for (size_t i = 0; i < n; i++) {
      Value key = unpack_value(c);
      v.map.emplace_back(key.s, unpack_value(c));
    }
    return v;
  }
  if ((t & 0xF0) == 0x90 || t == 0xDC || t == 0xDD) {   // array
    size_t n = (t & 0xF0) == 0x90 ? (t & 0x0F)
               : (t == 0xDC ? c.be(2) : c.be(4));
    v.kind = Value::ARR;
    for (size_t i = 0; i < n; i++) v.arr.push_back(unpack_value(c));
    return v;
  }
  if ((t & 0xE0) == 0xA0) { v.kind = Value::STR; v.s = c.bytes(t & 0x1F); return v; }
  switch (t) {
    case 0xC0: v.kind = Value::NIL; return v;
    case 0xC2: v.kind = Value::BOOL; v.b = false; return v;
    case 0xC3: v.kind = Value::BOOL; v.b = true; return v;
    case 0xC4: v.kind = Value::BIN; v.s = c.bytes(c.be(1)); return v;
    case 0xC5: v.kind = Value::BIN; v.s = c.bytes(c.be(2)); return v;
    case 0xC6: v.kind = Value::BIN; v.s = c.bytes(c.be(4)); return v;
    case 0xCA: {
      uint32_t bits = static_cast<uint32_t>(c.be(4));
      float f;
      memcpy(&f, &bits, 4);
      v.kind = Value::DBL;
      v.d = f;
      return v;
    }
    case 0xCB: {
      uint64_t bits = c.be(8);
      memcpy(&v.d, &bits, 8);
      v.kind = Value::DBL;
      return v;
    }
    case 0xCC: v.kind = Value::UINT; v.u = c.be(1); return v;
    case 0xCD: v.kind = Value::UINT; v.u = c.be(2); return v;
    case 0xCE: v.kind = Value::UINT; v.u = c.be(4); return v;
    case 0xCF: v.kind = Value::UINT; v.u = c.be(8); return v;
    case 0xD0: v.kind = Value::INT; v.i = static_cast<int8_t>(c.be(1)); return v;
    case 0xD1: v.kind = Value::INT; v.i = static_cast<int16_t>(c.be(2)); return v;
    case 0xD2: v.kind = Value::INT; v.i = static_cast<int32_t>(c.be(4)); return v;
    case 0xD3: v.kind = Value::INT; v.i = static_cast<int64_t>(c.be(8)); return v;
    case 0xD9: v.kind = Value::STR; v.s = c.bytes(c.be(1)); return v;
    case 0xDA: v.kind = Value::STR; v.s = c.bytes(c.be(2)); return v;
    case 0xDB: v.kind = Value::STR; v.s = c.bytes(c.be(4)); return v;
  }
  throw std::runtime_error("msgpack: unsupported type byte");
}

inline Value M() { Value v; v.kind = Value::MAP; return v; }
inline Value S(const std::string& s) { Value v; v.kind = Value::STR; v.s = s; return v; }
inline Value I(int64_t i) { Value v; v.kind = Value::INT; v.i = i; return v; }
inline Value B(bool b) { Value v; v.kind = Value::BOOL; v.b = b; return v; }
inline Value A() { Value v; v.kind = Value::ARR; return v; }

// ---------------------------------------------------------------- crc32
inline uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc = 0) {
  static const auto* table = [] {
    static uint32_t t[256];
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // namespace kvwire

#endif  // CURVINE_TORCH_KVWIRE_H
