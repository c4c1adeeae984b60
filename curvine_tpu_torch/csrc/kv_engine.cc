// The native engine of the master's KV metadata store: the port's own
// copy of the reference's csrc/kv_engine.cc, the C++ counterpart of
// the Python engine (curvine_tpu_torch/common/kvstore.py) with its
// on-disk format, in the role RocksDB plays for the reference's
// master. Either engine, of either package, opens the other's
// directory: the same WAL frames, the same CVSST02 segments, the same
// bloom filter and sparse index.
//
// Layout (common/kvstore.py's docstring is the specification):
//   wal-<gen>.log  [len u32 be][crc32 u32 be] msgpack [(key, val|nil)..]
//   seg-<gen>.sst  sorted [klen u32 be][vlen i32 be][key][value] entries
//                  (vlen -1 = tombstone), msgpack [sparse_index, bloom],
//                  footer [index_off u64 be][count u64 be] "CVSST02\0"
//
// Host code, not a device kernel. Single-threaded: the master is one
// event loop. The one exception is a scan cursor (ScanIter): when
// kv_scan_open makes it, it copies the memtable's items under its prefix
// and takes a shared_ptr of every segment, and reads nothing of the Store
// after that, so another thread may drain it with kv_scan_many while the
// loop writes, flushes and compacts (an unlinked segment stays readable
// through its own descriptor, which the shared_ptr keeps open; SegStream
// reads it with pread). The C interface below is bound with ctypes
// (curvine_tpu_torch/common/kvnative.py); gpu/_build.py compiles this
// file with the host C++ compiler at first use.

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <map>
#include <memory>
#include <optional>
#include <queue>
#include <stdexcept>
#include <string>
#include <vector>

#include "kvwire.h"

namespace {

using kvwire::Value;

constexpr char MAGIC[] = "CVSST02\0";
constexpr size_t MAGIC_LEN = 8;
constexpr size_t SPARSE = 64;
constexpr int BLOOM_BITS_PER_KEY = 10;
constexpr int BLOOM_K = 4;

thread_local std::string g_err;

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
uint64_t be64(const uint8_t* p) {
  return (uint64_t(be32(p)) << 32) | be32(p + 4);
}
void put_be32(std::string& out, uint32_t v) {
  char b[4] = {char(v >> 24), char(v >> 16), char(v >> 8), char(v)};
  out.append(b, 4);
}
void put_be64(std::string& out, uint64_t v) {
  put_be32(out, uint32_t(v >> 32));
  put_be32(out, uint32_t(v));
}

bool bloom_maybe(const std::string& bloom, const std::string& key) {
  size_t nbits = bloom.size() * 8;
  if (nbits == 0) return true;
  uint32_t h1 = kvwire::crc32((const uint8_t*)key.data(), key.size());
  uint32_t h2 =
      kvwire::crc32((const uint8_t*)key.data(), key.size(), 0x9E3779B9u) | 1;
  for (int i = 0; i < BLOOM_K; i++) {
    uint64_t b = (uint64_t(h1) + uint64_t(i) * h2) % nbits;
    if (!((uint8_t)bloom[b >> 3] & (1u << (b & 7)))) return false;
  }
  return true;
}

// a FORMAT error (bad magic/index): safe to drop the file, matching
// the python engine's ValueError handling. IO/alloc failures are NOT
// format errors and must never unlink data.
struct FormatError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

std::string read_file(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) throw std::runtime_error("open " + path + ": " + strerror(errno));
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string out(size_t(n), '\0');
  if (n && fread(out.data(), 1, size_t(n), f) != size_t(n)) {
    fclose(f);
    throw std::runtime_error("read " + path);
  }
  fclose(f);
  return out;
}

// one immutable sorted run (kvstore.py's Segment)
struct Segment {
  std::string path;
  uint64_t index_off = 0, count = 0;
  std::vector<std::pair<std::string, uint64_t>> index;
  std::string bloom;
  FILE* fh = nullptr;

  explicit Segment(const std::string& p) : path(p) {
    // footer + index block only — NOT the whole file (a multi-GB
    // compacted segment read into RAM on every open/flush would defeat
    // the engine's "namespace exceeds RAM" purpose; python parity:
    // kvstore.py Segment.__init__ seeks the tail)
    fh = fopen(p.c_str(), "rb");
    if (!fh) throw std::runtime_error("open " + p + ": " + strerror(errno));
    try {
      fseek(fh, 0, SEEK_END);
      long size = ftell(fh);
      if (size < long(16 + MAGIC_LEN))
        throw FormatError(p + ": truncated segment");
      uint8_t tail[16 + MAGIC_LEN];
      fseek(fh, size - long(sizeof tail), SEEK_SET);
      if (fread(tail, 1, sizeof tail, fh) != sizeof tail)
        throw std::runtime_error("read footer " + p);
      if (memcmp(tail + 16, MAGIC, MAGIC_LEN) != 0)
        throw FormatError(p + ": bad segment magic");
      index_off = be64(tail);
      count = be64(tail + 8);
      uint64_t blob_len = uint64_t(size) - sizeof tail;
      if (index_off > blob_len) throw FormatError(p + ": bad index offset");
      blob_len -= index_off;
      std::string data(blob_len, '\0');
      fseek(fh, long(index_off), SEEK_SET);
      if (blob_len && fread(data.data(), 1, blob_len, fh) != blob_len)
        throw std::runtime_error("read index " + p);
      try {
        kvwire::Cursor c{(const uint8_t*)data.data(), data.size(), 0};
        Value blob = kvwire::unpack_value(c);
        if (blob.kind != Value::ARR || blob.arr.size() != 2)
          throw FormatError(p + ": bad index block");
        for (auto& pair : blob.arr[0].arr)
          index.emplace_back(pair.arr[0].s, pair.arr[1].as_int());
        bloom = blob.arr[1].s;
      } catch (FormatError&) {
        throw;
      } catch (std::runtime_error& e) {  // msgpack parse errors = format
        throw FormatError(p + ": " + e.what());
      }
    } catch (...) {
      fclose(fh);  // dtor won't run when the ctor throws
      fh = nullptr;
      throw;
    }
  }
  ~Segment() {
    if (fh) fclose(fh);
  }
  Segment(const Segment&) = delete;

  // greatest index key <= key → file offset, 0-entry miss
  bool seek_slot(const std::string& key, uint64_t* off) const {
    size_t lo = 0, hi = index.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (index[mid].first <= key)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo == 0) return false;
    *off = index[lo - 1].second;
    return true;
  }

  enum class Got { MISS, TOMB, FOUND };
  Got get(const std::string& key, std::string* out) const {
    uint64_t off;
    if (index.empty() || !bloom_maybe(bloom, key) || !seek_slot(key, &off))
      return Got::MISS;
    fseek(fh, long(off), SEEK_SET);
    uint8_t hdr[8];
    for (size_t i = 0; i < SPARSE; i++) {
      if (uint64_t(ftell(fh)) >= index_off) return Got::MISS;
      if (fread(hdr, 1, 8, fh) != 8) return Got::MISS;
      uint32_t klen = be32(hdr);
      int32_t vlen = int32_t(be32(hdr + 4));
      std::string k(klen, '\0');
      if (fread(k.data(), 1, klen, fh) != klen) return Got::MISS;
      if (k == key) {
        if (vlen < 0) return Got::TOMB;
        out->resize(size_t(vlen));
        if (vlen && fread(out->data(), 1, size_t(vlen), fh) != size_t(vlen))
          return Got::MISS;
        return Got::FOUND;
      }
      if (k > key) return Got::MISS;
      if (vlen > 0) fseek(fh, vlen, SEEK_CUR);
    }
    return Got::MISS;
  }
};

using SegPtr = std::shared_ptr<Segment>;

// streaming reader over one segment (iter_from parity). It reads with
// pread on the segment's own descriptor, which the shared_ptr keeps open
// after a compaction unlinks the file; pread leaves the descriptor's
// offset alone, so Segment::get may seek and read it on the loop while
// another thread drains this stream. Nothing is read (nor the start
// looked up) until the first next(): opening a cursor touches no file.
struct SegStream {
  static constexpr size_t BUF = 1 << 20;
  SegPtr seg;
  std::string start;
  bool begun = false;
  uint64_t pos = 0;  // file offset of the next unread byte
  std::string buf;   // bytes [buf_off, buf_off + buf.size()) of the file
  uint64_t buf_off = 0;
  size_t buf_at = 0;

  SegStream(SegPtr s, const std::string& lo) : seg(std::move(s)), start(lo) {}

  // n bytes at pos into dst, through the buffer (a large read goes
  // straight to dst)
  bool read(void* dst, size_t n) {
    auto* out = static_cast<char*>(dst);
    while (n > 0) {
      size_t have = buf.size() - buf_at;
      if (have == 0) {
        uint64_t left = seg->index_off - pos;
        if (n >= BUF) {
          if (n > left) return false;
          if (!pread_all(out, n, pos)) return false;
          pos += n;
          return true;
        }
        size_t want = size_t(std::min<uint64_t>(BUF, left));
        if (want == 0) return false;
        buf.resize(want);
        if (!pread_all(buf.data(), want, pos)) return false;
        buf_off = pos;
        buf_at = 0;
        have = want;
      }
      size_t take = std::min(have, n);
      memcpy(out, buf.data() + buf_at, take);
      buf_at += take;
      out += take;
      n -= take;
      pos += take;
    }
    return true;
  }

  bool pread_all(char* dst, size_t n, uint64_t off) {
    int fd = fileno(seg->fh);
    while (n > 0) {
      ssize_t got = pread(fd, dst, n, off_t(off));
      if (got < 0 && errno == EINTR) continue;
      if (got <= 0) return false;
      dst += got;
      n -= size_t(got);
      off += uint64_t(got);
    }
    return true;
  }

  bool next(std::string* k, std::optional<std::string>* v) {
    if (!begun) {
      uint64_t off = 0;
      if (!start.empty()) seg->seek_slot(start, &off);
      pos = off;
      begun = true;
    }
    if (pos >= seg->index_off) return false;
    uint8_t hdr[8];
    if (!read(hdr, 8)) return false;
    uint32_t klen = be32(hdr);
    int32_t vlen = int32_t(be32(hdr + 4));
    k->resize(klen);
    if (klen && !read(k->data(), klen)) return false;
    if (vlen < 0) {
      v->reset();
    } else {
      std::string val(size_t(vlen), '\0');
      if (vlen && !read(val.data(), size_t(vlen))) return false;
      *v = std::move(val);
    }
    return true;
  }
};

using Mem = std::map<std::string, std::optional<std::string>>;

struct Store {
  std::string dir;
  bool do_fsync = false;
  uint64_t memtable_max = 8u << 20;
  int compact_threshold = 8;
  Mem mem;
  uint64_t mem_bytes = 0;
  uint64_t gen = 0;
  FILE* wal = nullptr;
  std::vector<std::string> wal_paths;
  std::vector<SegPtr> segments;  // oldest → newest

  void mem_put(const std::string& k, std::optional<std::string> v) {
    uint64_t new_sz = k.size() + (v ? v->size() : 0) + 32;
    auto it = mem.find(k);
    if (it == mem.end()) {
      mem_bytes += new_sz;
    } else {
      mem_bytes +=
          new_sz - (k.size() + (it->second ? it->second->size() : 0) + 32);
    }
    mem[k] = std::move(v);
  }

  void replay_wal(const std::string& path) {
    std::string data = read_file(path);
    size_t off = 0;
    while (off + 8 <= data.size()) {
      uint32_t length = be32((const uint8_t*)data.data() + off);
      uint32_t crc = be32((const uint8_t*)data.data() + off + 4);
      size_t start = off + 8, end = start + length;
      if (end > data.size() ||
          kvwire::crc32((const uint8_t*)data.data() + start, length) != crc) {
        // torn tail: truncate like the python engine
        if (truncate(path.c_str(), off) != 0) { /* best effort */ }
        break;
      }
      kvwire::Cursor c{(const uint8_t*)data.data() + start, length, 0};
      Value batch = kvwire::unpack_value(c);
      for (auto& pair : batch.arr) {
        if (pair.arr[1].kind == Value::NIL)
          mem_put(pair.arr[0].s, std::nullopt);
        else
          mem_put(pair.arr[0].s, pair.arr[1].s);
      }
      off = end;
    }
  }

  void open_dir() {
    mkdir(dir.c_str(), 0777);
    std::vector<std::pair<uint64_t, std::string>> segs, wals;
    DIR* d = opendir(dir.c_str());
    if (!d) throw std::runtime_error("opendir " + dir);
    while (dirent* e = readdir(d)) {
      std::string name = e->d_name;
      std::string full = dir + "/" + name;
      if (name.size() > 4 && name.substr(name.size() - 4) == ".tmp") {
        unlink(full.c_str());
      } else if (name.rfind("seg-", 0) == 0 &&
                 name.substr(name.size() - 4) == ".sst") {
        segs.emplace_back(strtoull(name.c_str() + 4, nullptr, 10), full);
      } else if (name.rfind("wal-", 0) == 0 &&
                 name.substr(name.size() - 4) == ".log") {
        wals.emplace_back(strtoull(name.c_str() + 4, nullptr, 10), full);
      }
    }
    closedir(d);
    std::sort(segs.begin(), segs.end());
    std::sort(wals.begin(), wals.end());
    for (auto& [g, path] : segs) {
      try {
        segments.push_back(std::make_shared<Segment>(path));
        gen = std::max(gen, g);
      } catch (FormatError&) {
        // FORMAT errors only (python parity: ValueError): a transient
        // IO/alloc failure must never unlink healthy data
        unlink(path.c_str());
      }
    }
    for (auto& [g, path] : wals) {
      gen = std::max(gen, g);
      replay_wal(path);
      wal_paths.push_back(path);
    }
  }

  void write_batch_payload(const uint8_t* payload, uint32_t len) {
    if (!wal) {
      gen++;
      char name[64];
      snprintf(name, sizeof name, "wal-%012llu.log",
               (unsigned long long)gen);
      std::string path = dir + "/" + name;
      wal = fopen(path.c_str(), "ab");
      if (!wal) throw std::runtime_error("open wal " + path);
      wal_paths.push_back(path);
    }
    std::string hdr;
    put_be32(hdr, len);
    put_be32(hdr, kvwire::crc32(payload, len));
    fwrite(hdr.data(), 1, hdr.size(), wal);
    fwrite(payload, 1, len, wal);
    fflush(wal);
    if (do_fsync) fsync(fileno(wal));
    kvwire::Cursor c{payload, len, 0};
    Value batch = kvwire::unpack_value(c);
    for (auto& pair : batch.arr) {
      if (pair.arr[1].kind == Value::NIL)
        mem_put(pair.arr[0].s, std::nullopt);
      else
        mem_put(pair.arr[0].s, pair.arr[1].s);
    }
    if (mem_bytes >= memtable_max) flush();
  }

  // items must arrive in sorted key order
  template <typename Iter>
  void write_segment(const std::string& path, Iter&& items) {
    std::string tmp = path + ".tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) throw std::runtime_error("open " + tmp);
    std::vector<std::pair<std::string, uint64_t>> index;
    std::vector<std::pair<uint32_t, uint32_t>> hashes;
    uint64_t n = 0, off = 0;
    std::string k;
    std::optional<std::string> v;
    while (items(&k, &v)) {
      if (n % SPARSE == 0) index.emplace_back(k, off);
      hashes.emplace_back(
          kvwire::crc32((const uint8_t*)k.data(), k.size()),
          kvwire::crc32((const uint8_t*)k.data(), k.size(), 0x9E3779B9u) | 1);
      std::string hdr;
      put_be32(hdr, uint32_t(k.size()));
      put_be32(hdr, v ? uint32_t(v->size()) : 0xFFFFFFFFu);  // -1 tomb
      fwrite(hdr.data(), 1, 8, f);
      fwrite(k.data(), 1, k.size(), f);
      off += 8 + k.size();
      if (v) {
        fwrite(v->data(), 1, v->size(), f);
        off += v->size();
      }
      n++;
    }
    uint64_t index_off = off;
    uint64_t nbits = std::max<uint64_t>(64, n * BLOOM_BITS_PER_KEY);
    nbits = (nbits + 7) / 8 * 8;
    std::string bits(nbits / 8, '\0');
    for (auto& [h1, h2] : hashes)
      for (int i = 0; i < BLOOM_K; i++) {
        uint64_t b = (uint64_t(h1) + uint64_t(i) * h2) % nbits;
        bits[b >> 3] |= char(1u << (b & 7));
      }
    Value blob;
    blob.kind = Value::ARR;
    Value idx;
    idx.kind = Value::ARR;
    for (auto& [ik, ioff] : index) {
      Value pair;
      pair.kind = Value::ARR;
      Value kk;
      kk.kind = Value::BIN;
      kk.s = ik;
      Value oo;
      oo.kind = Value::UINT;
      oo.u = ioff;
      pair.arr = {kk, oo};
      idx.arr.push_back(std::move(pair));
    }
    Value bl;
    bl.kind = Value::BIN;
    bl.s = bits;
    blob.arr = {std::move(idx), std::move(bl)};
    std::string packed;
    kvwire::pack_value(packed, blob);
    fwrite(packed.data(), 1, packed.size(), f);
    std::string foot;
    put_be64(foot, index_off);
    put_be64(foot, n);
    foot.append(MAGIC, MAGIC_LEN);
    fwrite(foot.data(), 1, foot.size(), f);
    fflush(f);
    fsync(fileno(f));
    fclose(f);
    if (rename(tmp.c_str(), path.c_str()) != 0)
      throw std::runtime_error("rename " + tmp);
  }

  std::string seg_path() {
    char name[64];
    snprintf(name, sizeof name, "seg-%012llu.sst", (unsigned long long)gen);
    return dir + "/" + name;
  }

  void flush() {
    if (!mem.empty()) {
      gen++;
      auto it = mem.begin();
      auto src = [&](std::string* k, std::optional<std::string>* v) {
        if (it == mem.end()) return false;
        *k = it->first;
        *v = it->second;
        ++it;
        return true;
      };
      std::string path = seg_path();
      write_segment(path, src);
      segments.push_back(std::make_shared<Segment>(path));
      mem.clear();
      mem_bytes = 0;
    }
    if (wal) {
      fclose(wal);
      wal = nullptr;
    }
    for (auto& p : wal_paths) unlink(p.c_str());
    wal_paths.clear();
    if (int(segments.size()) > compact_threshold) compact_tiered();
  }

  // k-way merge across a suffix of segments, newest wins
  struct Merge {
    struct Src {
      std::unique_ptr<SegStream> st;
      std::string k;
      std::optional<std::string> v;
      int rank;  // lower = newer
      bool ok;
    };
    std::vector<Src> srcs;
    std::string start;
    std::string last;
    bool have_last = false;
    bool primed = false;
    bool drop_tombs;

    // opens (and seeks) every segment's stream; their first entries are
    // read at the first next(), so a scan cursor opened on the master's
    // loop reads no record there (its drainer reads them)
    Merge(const std::vector<SegPtr>& segs, bool drop, const std::string& lo)
        : start(lo), drop_tombs(drop) {
      int rank = 0;
      for (auto it = segs.rbegin(); it != segs.rend(); ++it, ++rank)
        srcs.push_back(Src{std::make_unique<SegStream>(*it, start), "",
                           std::nullopt, rank, false});
    }

    void prime() {
      for (auto& s : srcs) {
        s.ok = s.st->next(&s.k, &s.v);
        // iter_from parity: skip entries below start
        while (s.ok && s.k < start) s.ok = s.st->next(&s.k, &s.v);
      }
      primed = true;
    }

    bool next(std::string* k, std::optional<std::string>* v) {
      if (!primed) prime();
      for (;;) {
        int best = -1;
        for (size_t i = 0; i < srcs.size(); i++) {
          if (!srcs[i].ok) continue;
          if (best < 0 || srcs[i].k < srcs[best].k ||
              (srcs[i].k == srcs[best].k &&
               srcs[i].rank < srcs[best].rank))
            best = int(i);
        }
        if (best < 0) return false;
        Src& s = srcs[best];
        std::string key = s.k;
        std::optional<std::string> val = s.v;
        s.ok = s.st->next(&s.k, &s.v);
        if (have_last && key == last) continue;
        last = key;
        have_last = true;
        if (!val && drop_tombs) continue;
        *k = std::move(key);
        *v = std::move(val);
        return true;
      }
    }
  };

  void compact_full() {
    if (segments.size() <= 1) return;
    gen++;
    Merge m(segments, /*drop_tombs=*/true, "");
    auto src = [&](std::string* k, std::optional<std::string>* v) {
      return m.next(k, v);
    };
    std::string path = seg_path();
    write_segment(path, src);
    for (auto& s : segments) unlink(s->path.c_str());
    segments.clear();
    segments.push_back(std::make_shared<Segment>(path));
  }

  void compact_tiered() {
    if (segments.size() <= 1) return;
    std::vector<uint64_t> sizes;
    for (auto& s : segments) {
      struct stat st;
      sizes.push_back(stat(s->path.c_str(), &st) == 0 ? uint64_t(st.st_size)
                                                      : 0);
    }
    size_t start = segments.size() - 1;
    uint64_t acc = sizes[start];
    while (start > 0 && sizes[start - 1] <= 2 * acc) {
      start--;
      acc += sizes[start];
    }
    if (start == segments.size() - 1) start--;
    std::vector<SegPtr> victims(segments.begin() + start, segments.end());
    bool full = start == 0;
    gen++;
    Merge m(victims, full, "");
    auto src = [&](std::string* k, std::optional<std::string>* v) {
      return m.next(k, v);
    };
    std::string path = seg_path();
    write_segment(path, src);
    for (auto& s : victims) unlink(s->path.c_str());
    segments.resize(start);
    segments.push_back(std::make_shared<Segment>(path));
  }

  bool get(const std::string& key, std::string* out, bool* found) {
    auto it = mem.find(key);
    if (it != mem.end()) {
      if (!it->second) {
        *found = false;
        return true;
      }
      *out = *it->second;
      *found = true;
      return true;
    }
    for (auto sit = segments.rbegin(); sit != segments.rend(); ++sit) {
      std::string v;
      switch ((*sit)->get(key, &v)) {
        case Segment::Got::FOUND:
          *out = std::move(v);
          *found = true;
          return true;
        case Segment::Got::TOMB:
          *found = false;
          return true;
        case Segment::Got::MISS:
          break;
      }
    }
    *found = false;
    return true;
  }

  void clear() {
    if (wal) {
      fclose(wal);
      wal = nullptr;
    }
    for (auto& s : segments) unlink(s->path.c_str());
    segments.clear();
    for (auto& p : wal_paths) unlink(p.c_str());
    wal_paths.clear();
    mem.clear();
    mem_bytes = 0;
  }
};

// scan iterator: memtable snapshot merged over the segment merge,
// memtable shadows, tombstones skipped, bounded by prefix
struct ScanIter {
  std::vector<std::pair<std::string, std::optional<std::string>>> mem_items;
  size_t mi = 0;
  std::unique_ptr<Store::Merge> segs;
  std::string prefix;
  std::string cur_k, cur_v;
  std::string pending_k;
  std::optional<std::string> pending_v;
  bool pending_ok = false;
  bool started = false;  // the segments' first entry read (first next())
  bool held = false;  // kv_scan_many: current item not yet delivered

  ScanIter(Store& st, const std::string& pfx, const std::string& lo)
      : prefix(pfx) {
    // the memtable's items from lo to the end of the prefix, no further:
    // a cursor opened on the master's loop costs what its prefix holds
    // in the memtable, not the memtable's tail
    for (auto it = st.mem.lower_bound(lo); it != st.mem.end(); ++it) {
      if (!pfx.empty() && it->first.compare(0, pfx.size(), pfx) != 0) break;
      mem_items.emplace_back(it->first, it->second);
    }
    segs = std::make_unique<Store::Merge>(st.segments, false, lo);
  }

  bool next() {
    if (!started) {
      pending_ok = segs->next(&pending_k, &pending_v);
      started = true;
    }
    for (;;) {
      bool have_mem = mi < mem_items.size();
      std::string k;
      std::optional<std::string> v;
      if (!have_mem && !pending_ok) return false;
      if (!pending_ok ||
          (have_mem && mem_items[mi].first <= pending_k)) {
        if (pending_ok && mem_items[mi].first == pending_k)
          pending_ok = segs->next(&pending_k, &pending_v);
        k = std::move(mem_items[mi].first);
        v = std::move(mem_items[mi].second);
        mi++;
      } else {
        k = std::move(pending_k);
        v = std::move(pending_v);
        pending_ok = segs->next(&pending_k, &pending_v);
      }
      if (!prefix.empty() && k.compare(0, prefix.size(), prefix) != 0)
        return false;  // sorted: past the prefix means done
      if (!v) continue;  // tombstone
      cur_k = std::move(k);
      cur_v = std::move(*v);
      return true;
    }
  }
};

}  // namespace

// ----------------------------------------------------------------- C ABI
extern "C" {

const char* kv_errmsg() { return g_err.c_str(); }

void* kv_open(const char* dir, int do_fsync, uint64_t memtable_max,
              int compact_threshold) {
  try {
    auto* s = new Store();
    s->dir = dir;
    s->do_fsync = do_fsync != 0;
    if (memtable_max) s->memtable_max = memtable_max;
    if (compact_threshold) s->compact_threshold = compact_threshold;
    s->open_dir();
    return s;
  } catch (std::exception& e) {
    g_err = e.what();
    return nullptr;
  }
}

int kv_write_batch(void* h, const uint8_t* payload, uint32_t len) {
  try {
    static_cast<Store*>(h)->write_batch_payload(payload, len);
    return 0;
  } catch (std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

// 1 = found (*out malloc'd, caller frees via kv_free), 0 = absent, -1 err
int kv_get(void* h, const uint8_t* key, uint32_t klen, uint8_t** out,
           uint32_t* outlen) {
  try {
    std::string v;
    bool found = false;
    static_cast<Store*>(h)->get(std::string((const char*)key, klen), &v,
                                &found);
    if (!found) return 0;
    *out = (uint8_t*)malloc(v.size() ? v.size() : 1);
    memcpy(*out, v.data(), v.size());
    *outlen = uint32_t(v.size());
    return 1;
  } catch (std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

void kv_free(void* p) { free(p); }

int kv_flush(void* h) {
  try {
    static_cast<Store*>(h)->flush();
    return 0;
  } catch (std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

int kv_compact(void* h) {
  try {
    static_cast<Store*>(h)->flush();
    static_cast<Store*>(h)->compact_full();
    return 0;
  } catch (std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

int kv_clear(void* h) {
  try {
    static_cast<Store*>(h)->clear();
    return 0;
  } catch (std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

void kv_close(void* h) {
  auto* s = static_cast<Store*>(h);
  try {
    s->flush();
  } catch (std::exception&) {
  }
  if (s->wal) fclose(s->wal);
  delete s;
}

void* kv_scan_open(void* h, const uint8_t* prefix, uint32_t plen,
                   const uint8_t* start, uint32_t slen) {
  try {
    std::string pfx((const char*)prefix, plen);
    std::string lo = slen ? std::string((const char*)start, slen) : pfx;
    return new ScanIter(*static_cast<Store*>(h), pfx, lo);
  } catch (std::exception& e) {
    g_err = e.what();
    return nullptr;
  }
}

// 1 = item (pointers valid until the next call), 0 = end, -1 = error
int kv_scan_next(void* it, const uint8_t** k, uint32_t* klen,
                 const uint8_t** v, uint32_t* vlen) {
  try {
    auto* s = static_cast<ScanIter*>(it);
    if (!s->next()) return 0;
    *k = (const uint8_t*)s->cur_k.data();
    *klen = uint32_t(s->cur_k.size());
    *v = (const uint8_t*)s->cur_v.data();
    *vlen = uint32_t(s->cur_v.size());
    return 1;
  } catch (std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

void kv_scan_close(void* it) { delete static_cast<ScanIter*>(it); }

// the memtable items a cursor copied when it was opened
uint64_t kv_scan_mem_items(void* it) {
  return static_cast<ScanIter*>(it)->mem_items.size();
}

// Batched scan: fills buf with consecutive
// [klen u32 le][vlen u32 le][key][value] records. Returns bytes
// written (0 = exhausted, -1 = error, < -1 = one item needs -n bytes —
// grow the buffer and call again; the item stays held). One ctypes
// round trip per BUFFER instead of per item — the per-item FFI cost
// made the naive cursor slower than pure python on big scans.
int64_t kv_scan_many(void* itp, uint8_t* buf, uint32_t buflen) {
  try {
    auto* it = static_cast<ScanIter*>(itp);
    uint32_t off = 0;
    for (;;) {
      if (!it->held) {
        if (!it->next()) break;
        it->held = true;
      }
      uint64_t need = 8 + it->cur_k.size() + it->cur_v.size();
      if (off + need > buflen) {
        if (off == 0)
          return -int64_t(need);  // caller grows the buffer and retries
        break;  // held item delivered next call
      }
      uint32_t kl = uint32_t(it->cur_k.size());
      uint32_t vl = uint32_t(it->cur_v.size());
      memcpy(buf + off, &kl, 4);
      memcpy(buf + off + 4, &vl, 4);
      memcpy(buf + off + 8, it->cur_k.data(), kl);
      memcpy(buf + off + 8 + kl, it->cur_v.data(), vl);
      off += uint32_t(need);
      it->held = false;
    }
    return off;
  } catch (std::exception& e) {
    g_err = e.what();
    return -1;
  }
}

uint64_t kv_mem_bytes(void* h) { return static_cast<Store*>(h)->mem_bytes; }
uint64_t kv_segment_count(void* h) {
  return static_cast<Store*>(h)->segments.size();
}

}  // extern "C"
