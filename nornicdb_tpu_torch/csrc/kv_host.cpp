// kv_host — log-structured persistent KV store (the port's copy of
// native/nornickv.cpp; the same on-disk format, byte for byte, so either
// package opens a store the other wrote).
//
// Every acknowledged mutation is on disk (an append-only segment log);
// open rebuilds the in-RAM key index by scanning the segments, tombstones
// mark deletes, and compaction rewrites the live records when dead bytes
// accumulate. CRC-framed records give torn-tail repair after a crash.
//
// Exposed as a flat C ABI for ctypes (storage/disk.py); built by
// ops/_build.py:host_library.
//
// Two changes from the reference's copy leave every byte on disk as it
// was: open reads each segment in large blocks and parses the records in
// memory (two read(2) calls per record cost seconds on a slow file
// system at 100,000 nodes), and reads of sealed segments go through
// descriptors kept open (one open(2) per segment, not one per value).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4E4B5631;  // "NKV1"
constexpr uint8_t kOpPut = 1;
constexpr uint8_t kOpDel = 2;

// CRC32 (IEEE), small table-driven implementation.
uint32_t crc_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  }
} crc_init;

uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc = 0) {
  crc = ~crc;
  for (size_t i = 0; i < n; i++) crc = crc_table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

struct Loc {
  uint32_t segment;
  uint64_t offset;   // offset of record start
  uint32_t vlen;
  uint64_t voffset;  // offset of value bytes within segment
};

std::string seg_name(const std::string& dir, uint32_t id) {
  char buf[32];
  snprintf(buf, sizeof buf, "/kv-%06u.log", id);
  return dir + buf;
}

struct Store {
  std::string dir;
  bool sync_every_write = false;
  uint64_t max_segment_bytes = 64ull << 20;
  int active_fd = -1;
  uint32_t active_seg = 0;
  uint64_t active_off = 0;
  std::map<std::string, Loc> index;  // ordered: prefix scans are ranges
  uint64_t live_bytes = 0, dead_bytes = 0;
  int repaired = 0;  // torn-tail truncations performed during open
  std::shared_mutex mu;
  // read-only descriptors of sealed segments, opened on first read
  std::mutex ro_mu;
  std::unordered_map<uint32_t, int> ro_fds;

  void close_ro() {
    std::lock_guard<std::mutex> g(ro_mu);
    for (auto& [id, fd] : ro_fds) ::close(fd);
    ro_fds.clear();
  }

  ~Store() {
    if (active_fd >= 0) ::close(active_fd);
    close_ro();
  }
};

bool write_all(int fd, const void* buf, size_t n) {
  size_t put = 0;
  while (put < n) {
    ssize_t r = ::write(fd, (const char*)buf + put, n - put);
    if (r < 0) return false;
    put += (size_t)r;
  }
  return true;
}

// Scan one segment, updating the index. Returns false on unrecoverable IO
// error. A corrupt/truncated record truncates the file there (torn tail);
// a tail shorter than a header is left as it is. The file is read whole,
// in large blocks, and parsed in memory.
bool scan_segment(Store* s, uint32_t seg_id) {
  std::string path = seg_name(s->dir, seg_id);
  int fd = ::open(path.c_str(), O_RDWR);
  if (fd < 0) return false;
  struct stat st;
  if (::fstat(fd, &st) != 0) { ::close(fd); return false; }
  std::vector<uint8_t> buf((size_t)st.st_size);
  size_t got = 0;
  while (got < buf.size()) {
    ssize_t r = ::read(fd, buf.data() + got, std::min<size_t>(buf.size() - got, 8u << 20));
    if (r < 0) { ::close(fd); return false; }
    if (r == 0) break;
    got += (size_t)r;
  }
  buf.resize(got);
  const size_t kHdr = 13;  // magic(4) op(1) klen(4) vlen(4)
  uint64_t off = 0;
  for (;;) {
    if (buf.size() - off < kHdr) break;  // clean EOF or short tail
    const uint8_t* hdr = buf.data() + off;
    uint32_t magic, klen, vlen;
    memcpy(&magic, hdr, 4);
    uint8_t op = hdr[4];
    memcpy(&klen, hdr + 5, 4);
    memcpy(&vlen, hdr + 9, 4);
    if (magic != kMagic || (op != kOpPut && op != kOpDel) ||
        klen > (64u << 20) || vlen > (1u << 30)) {
      // corrupt header: truncate here
      if (::ftruncate(fd, (off_t)off) == 0) s->repaired++;
      break;
    }
    uint64_t body_len = (uint64_t)klen + vlen + 4;
    if (buf.size() - off - kHdr < body_len) {
      if (::ftruncate(fd, (off_t)off) == 0) s->repaired++;
      break;
    }
    const uint8_t* body = hdr + kHdr;
    uint32_t want;
    memcpy(&want, body + klen + vlen, 4);
    uint32_t crc = crc32(hdr + 4, 9);
    crc = crc32(body, klen + vlen, crc);
    if (want != crc) {
      if (::ftruncate(fd, (off_t)off) == 0) s->repaired++;
      break;
    }
    std::string key((const char*)body, klen);
    uint64_t rec_len = kHdr + body_len;
    auto it = s->index.find(key);
    if (it != s->index.end()) {
      // the superseded record stops being live regardless of the new op
      s->dead_bytes += it->second.vlen + (uint64_t)it->first.size() + 17;
      s->live_bytes -= it->second.vlen + key.size() + 17;
      s->index.erase(it);
    }
    if (op == kOpPut) {
      Loc loc{seg_id, off, vlen, off + kHdr + klen};
      s->index[key] = loc;
      s->live_bytes += rec_len;
    } else {
      s->dead_bytes += rec_len;  // tombstone itself is dead weight
    }
    off += rec_len;
  }
  ::close(fd);
  if (seg_id == s->active_seg) s->active_off = off;
  return true;
}

int open_active(Store* s) {
  std::string path = seg_name(s->dir, s->active_seg);
  s->active_fd = ::open(path.c_str(), O_CREAT | O_RDWR | O_APPEND, 0644);
  return s->active_fd < 0 ? -1 : 0;
}

int roll_segment_locked(Store* s) {
  if (s->active_fd >= 0) {
    ::fsync(s->active_fd);
    ::close(s->active_fd);
  }
  s->active_seg++;
  s->active_off = 0;
  return open_active(s);
}

int append_locked(Store* s, uint8_t op, const char* k, uint32_t klen,
                  const char* v, uint32_t vlen) {
  if (s->active_off >= s->max_segment_bytes)
    if (roll_segment_locked(s) != 0) return -1;
  uint8_t hdr[13];
  memcpy(hdr, &kMagic, 4);
  hdr[4] = op;
  memcpy(hdr + 5, &klen, 4);
  memcpy(hdr + 9, &vlen, 4);
  uint32_t crc = crc32(hdr + 4, 9);
  crc = crc32((const uint8_t*)k, klen, crc);
  if (vlen) crc = crc32((const uint8_t*)v, vlen, crc);
  std::vector<uint8_t> rec(sizeof hdr + klen + vlen + 4);
  memcpy(rec.data(), hdr, sizeof hdr);
  memcpy(rec.data() + sizeof hdr, k, klen);
  if (vlen) memcpy(rec.data() + sizeof hdr + klen, v, vlen);
  memcpy(rec.data() + sizeof hdr + klen + vlen, &crc, 4);
  if (!write_all(s->active_fd, rec.data(), rec.size())) {
    // a partial write (ENOSPC etc.) must not desync active_off from real
    // EOF: roll the file back to the last good record boundary
    ::ftruncate(s->active_fd, (off_t)s->active_off);
    return -1;
  }
  uint64_t off = s->active_off;
  s->active_off += rec.size();
  if (s->sync_every_write) ::fsync(s->active_fd);

  std::string key(k, klen);
  auto it = s->index.find(key);
  if (it != s->index.end()) {
    s->dead_bytes += it->second.vlen + key.size() + 17;
    s->live_bytes -= it->second.vlen + key.size() + 17;
    s->index.erase(it);
  }
  if (op == kOpPut) {
    s->index[key] = Loc{s->active_seg, off, vlen, off + sizeof hdr + klen};
    s->live_bytes += rec.size();
  } else {
    s->dead_bytes += rec.size();
  }
  return 0;
}

// A read-only descriptor of sealed segment ``id``, opened on first use.
int sealed_fd(Store* s, uint32_t id) {
  std::lock_guard<std::mutex> g(s->ro_mu);
  auto it = s->ro_fds.find(id);
  if (it != s->ro_fds.end()) return it->second;
  int fd = ::open(seg_name(s->dir, id).c_str(), O_RDONLY);
  if (fd >= 0) s->ro_fds[id] = fd;
  return fd;
}

int read_value(Store* s, const Loc& loc, char** val, int* vlen) {
  *val = (char*)malloc(loc.vlen ? loc.vlen : 1);
  if (!*val) return -1;
  *vlen = (int)loc.vlen;
  if (loc.vlen == 0) return 0;
  if (loc.segment == s->active_seg && s->active_fd >= 0) {
    ssize_t r = ::pread(s->active_fd, *val, loc.vlen, (off_t)loc.voffset);
    if (r == (ssize_t)loc.vlen) return 0;
  }
  int fd = sealed_fd(s, loc.segment);
  if (fd < 0) { free(*val); return -1; }
  ssize_t r = ::pread(fd, *val, loc.vlen, (off_t)loc.voffset);
  if (r != (ssize_t)loc.vlen) { free(*val); return -1; }
  return 0;
}

struct ScanIter {
  Store* store;
  std::vector<std::string> keys;
  size_t pos = 0;
};

}  // namespace

extern "C" {

void* nkv_open(const char* dir, int sync_every_write, long max_segment_bytes) {
  auto s = std::make_unique<Store>();
  s->dir = dir;
  s->sync_every_write = sync_every_write != 0;
  if (max_segment_bytes > 0) s->max_segment_bytes = (uint64_t)max_segment_bytes;
  ::mkdir(dir, 0755);
  // discover segments
  std::vector<uint32_t> segs;
  if (DIR* d = ::opendir(dir)) {
    while (dirent* e = ::readdir(d)) {
      unsigned id;
      if (sscanf(e->d_name, "kv-%06u.log", &id) == 1) segs.push_back(id);
    }
    ::closedir(d);
  }
  std::sort(segs.begin(), segs.end());
  s->active_seg = segs.empty() ? 0 : segs.back();
  for (uint32_t id : segs)
    if (!scan_segment(s.get(), id)) return nullptr;
  if (open_active(s.get()) != 0) return nullptr;
  return s.release();
}

int nkv_put(void* h, const char* k, int klen, const char* v, int vlen) {
  auto* s = (Store*)h;
  std::unique_lock lock(s->mu);
  return append_locked(s, kOpPut, k, (uint32_t)klen, v, (uint32_t)vlen);
}

int nkv_get(void* h, const char* k, int klen, char** val, int* vlen) {
  auto* s = (Store*)h;
  std::shared_lock lock(s->mu);
  auto it = s->index.find(std::string(k, klen));
  if (it == s->index.end()) return 1;
  return read_value(s, it->second, val, vlen) == 0 ? 0 : -1;
}

int nkv_has(void* h, const char* k, int klen) {
  auto* s = (Store*)h;
  std::shared_lock lock(s->mu);
  return s->index.count(std::string(k, klen)) ? 1 : 0;
}

int nkv_delete(void* h, const char* k, int klen) {
  auto* s = (Store*)h;
  std::unique_lock lock(s->mu);
  if (!s->index.count(std::string(k, klen))) return 1;
  return append_locked(s, kOpDel, k, (uint32_t)klen, nullptr, 0);
}

long nkv_count(void* h) {
  auto* s = (Store*)h;
  std::shared_lock lock(s->mu);
  return (long)s->index.size();
}

long nkv_count_prefix(void* h, const char* p, int plen) {
  auto* s = (Store*)h;
  std::shared_lock lock(s->mu);
  std::string prefix(p, plen);
  long n = 0;
  for (auto it = s->index.lower_bound(prefix);
       it != s->index.end() && it->first.compare(0, prefix.size(), prefix) == 0;
       ++it)
    n++;
  return n;
}

long nkv_live_bytes(void* h) {
  auto* s = (Store*)h;
  std::shared_lock lock(s->mu);
  return (long)s->live_bytes;
}

long nkv_dead_bytes(void* h) {
  auto* s = (Store*)h;
  std::shared_lock lock(s->mu);
  return (long)s->dead_bytes;
}

int nkv_repaired(void* h) {
  auto* s = (Store*)h;
  return s->repaired;
}

int nkv_sync(void* h) {
  auto* s = (Store*)h;
  std::unique_lock lock(s->mu);
  return s->active_fd >= 0 ? ::fsync(s->active_fd) : 0;
}

// Rewrite all live records into fresh segments, drop old ones.
int nkv_compact(void* h) {
  auto* s = (Store*)h;
  std::unique_lock lock(s->mu);
  uint32_t first_new = s->active_seg + 1;
  std::vector<uint32_t> old_segs;
  for (uint32_t id = 0; id <= s->active_seg; id++) {
    struct stat st;
    if (::stat(seg_name(s->dir, id).c_str(), &st) == 0) old_segs.push_back(id);
  }
  // snapshot live entries (key -> value bytes)
  std::vector<std::pair<std::string, std::string>> live;
  live.reserve(s->index.size());
  for (auto& [key, loc] : s->index) {
    char* v = nullptr;
    int vlen = 0;
    if (read_value(s, loc, &v, &vlen) != 0) return -1;
    live.emplace_back(key, std::string(v, (size_t)vlen));
    free(v);
  }
  if (s->active_fd >= 0) { ::fsync(s->active_fd); ::close(s->active_fd); }
  s->active_seg = first_new;
  s->active_off = 0;
  s->index.clear();
  s->live_bytes = s->dead_bytes = 0;
  if (open_active(s) != 0) return -1;
  for (auto& [key, val] : live)
    if (append_locked(s, kOpPut, key.data(), (uint32_t)key.size(), val.data(),
                      (uint32_t)val.size()) != 0)
      return -1;
  ::fsync(s->active_fd);
  s->close_ro();
  for (uint32_t id : old_segs) ::unlink(seg_name(s->dir, id).c_str());
  return 0;
}

void* nkv_scan(void* h, const char* p, int plen) {
  auto* s = (Store*)h;
  auto* it = new ScanIter();
  it->store = s;
  std::shared_lock lock(s->mu);
  std::string prefix(p, plen);
  for (auto i = s->index.lower_bound(prefix);
       i != s->index.end() && i->first.compare(0, prefix.size(), prefix) == 0;
       ++i)
    it->keys.push_back(i->first);
  return it;
}

int nkv_scan_next(void* iter, char** k, int* klen, char** v, int* vlen) {
  auto* it = (ScanIter*)iter;
  Store* s = it->store;
  while (it->pos < it->keys.size()) {
    const std::string& key = it->keys[it->pos++];
    std::shared_lock lock(s->mu);
    auto found = s->index.find(key);
    if (found == s->index.end()) continue;  // deleted since snapshot
    *k = (char*)malloc(key.size() ? key.size() : 1);
    memcpy(*k, key.data(), key.size());
    *klen = (int)key.size();
    if (read_value(s, found->second, v, vlen) != 0) { free(*k); return -1; }
    return 0;
  }
  return 1;  // exhausted
}

void nkv_scan_free(void* iter) { delete (ScanIter*)iter; }

void nkv_free(char* p) { free(p); }

void nkv_close(void* h) {
  auto* s = (Store*)h;
  {
    std::unique_lock lock(s->mu);
    if (s->active_fd >= 0) { ::fsync(s->active_fd); ::close(s->active_fd); s->active_fd = -1; }
  }
  delete s;
}

}  // extern "C"
