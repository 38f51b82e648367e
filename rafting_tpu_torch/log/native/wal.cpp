// Native WAL storage engine for the TPU Multi-Raft node.
//
// Role: the durability tier under the device-resident log rings — the
// TPU-native replacement for the reference's only native component, the
// embedded RocksDB log store (curioloop/rafting pom.xml:17-21,
// command/storage/RocksLog.java).  Where the reference opens one RocksDB
// per Raft group and fsyncs its WAL per group (RocksLog.java:55-89), this
// engine journals ALL groups of a node into one segmented append-only log
// and amortizes a single fsync over every group's writes in a tick — the
// group-commit discipline the vectorized engine's batch step makes natural.
//
// Record types (all integers little-endian; every record CRC-framed):
//   ENTRY     (group, index, term, payload)  — replicated-log entry
//   STABLE    (group, term, ballot)          — durable (currentTerm, votedFor),
//                                              the reference's StableLock record
//                                              (support/StableLock.java:69-80)
//   TRUNCATE  (group, from)                  — suffix truncation marker
//   MILESTONE (group, index, term)           — snapshot milestone / log floor
//                                              (StableLock.java:82-91 + RocksLog
//                                               epoch column, RocksLog.java:228-242)
//
// Recovery replays segments in order, dropping the tail after the first
// CRC/length mismatch (torn write).  Checkpointing rewrites live state into
// a fresh segment and deletes older ones (the deleteRange analog).
//
// Exposed as a C ABI consumed from Python via ctypes (no pybind11 in the
// toolchain).  Single-threaded by contract: one node runtime thread owns a
// handle.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <map>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x52574131;  // "RWA1"
constexpr uint8_t kEntry = 1;
constexpr uint8_t kStable = 2;
constexpr uint8_t kTruncate = 3;
constexpr uint8_t kMilestone = 4;
constexpr uint8_t kReset = 5;  // group destroyed: forget ALL its state

// CRC-32 (IEEE), small table-driven implementation.
uint32_t crc_table[256];
bool crc_init_done = false;
void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}
uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc = 0) {
  crc_init();
  crc = ~crc;
  for (size_t i = 0; i < n; i++) crc = crc_table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

struct EntryRef {
  int64_t term;
  uint32_t seg;     // segment id holding the payload
  uint64_t off;     // offset of payload bytes within the segment
  uint32_t len;     // payload length
};

struct GroupState {
  int64_t tail = 0;          // last live index (0 = empty)
  int64_t floor = 0;         // compaction floor ("epoch")
  int64_t floor_term = 0;    // term at the floor (snapshot milestone term)
  int64_t stable_term = 0;   // durable currentTerm
  int64_t ballot = -1;       // durable votedFor (-1 = none)
  bool has_stable = false;
  std::map<uint64_t, EntryRef> entries;  // live index -> payload ref

  void drop_suffix(uint64_t from) {
    entries.erase(entries.lower_bound(from), entries.end());
    if (tail >= (int64_t)from) tail = (int64_t)from - 1;
  }
  void drop_prefix(uint64_t upto) {  // drop indices <= upto
    entries.erase(entries.begin(), entries.upper_bound(upto));
  }
};

using GroupMap = std::unordered_map<uint32_t, GroupState>;

// Three-phase GC bookkeeping (begin on the tick thread, rewrite on a worker,
// finish on the tick thread).  `frozen` and `repoint` are immutable to the
// tick thread while `pending`; only the worker writes them.
struct GcRepoint {
  uint32_t g;
  uint64_t idx;
  int64_t term;
  uint64_t off;   // payload offset within the compacted base segment
  uint32_t len;
};
struct GcState {
  bool pending = false;     // gc_begin done, gc_finish not yet
  bool rewritten = false;   // gc_rewrite completed (worker -> tick handoff)
  std::vector<uint32_t> frozen;  // sealed segment ids (ascending)
  std::vector<GcRepoint> repoint;
};

struct Wal {
  std::string dir;
  uint64_t segment_bytes;
  GroupMap groups;
  // open segment
  int fd = -1;
  uint32_t seg_id = 0;
  uint64_t seg_off = 0;
  std::vector<uint8_t> buf;        // pending (unflushed) records
  std::vector<uint32_t> live_segs; // existing segment ids, ascending
  GcState gc;
  std::string err;
  // Injectable fault table (testkit/faultfs): countdowns fire once then
  // disarm (-1).  `poisoned` latches for the handle lifetime — a failed
  // fsync is never retried on the same fd (fail-stop contract, PARITY.md).
  int64_t fault_fsync_after = -1;
  int64_t fault_fsync_errno = EIO;
  int64_t fault_write_after = -1;
  int64_t fault_write_errno = EIO;
  int64_t fault_short_after = -1;
  int64_t fault_short_keep = 0;
  int64_t sync_delay_us = 0;
  bool poisoned = false;
  int last_errno = 0;
  // Cumulative per-handle (= per-stripe) instrumentation, exported
  // zero-copy via wal_stats().  Atomics because wal_pack_ae workers reach
  // arbitrary shards (`gs[c] % n_shards`); the stage/fsync writers are
  // single-threaded per handle by contract, so relaxed ordering suffices.
  std::atomic<uint64_t> stat_stage_ns{0};
  std::atomic<uint64_t> stat_fsync_ns{0};
  std::atomic<uint64_t> stat_pack_ns{0};
  std::atomic<uint64_t> stat_bytes{0};
  std::atomic<uint64_t> stat_stage_calls{0};
  std::atomic<uint64_t> stat_fsync_calls{0};
  std::atomic<uint64_t> stat_pack_calls{0};
};

// Countdown semantics: after=N arms the fault for the (N+1)-th guarded call.
bool fault_fire(int64_t& after) {
  if (after < 0) return false;
  if (after == 0) { after = -1; return true; }
  after--;
  return false;
}

std::string seg_path_in(const std::string& dir, uint32_t id) {
  char name[32];
  std::snprintf(name, sizeof name, "%08u.wal", id);
  return dir + "/" + name;
}

std::string seg_path(const Wal& w, uint32_t id) {
  return seg_path_in(w.dir, id);
}

void put_u32(std::vector<uint8_t>& b, uint32_t v) {
  b.push_back(v & 0xFF); b.push_back((v >> 8) & 0xFF);
  b.push_back((v >> 16) & 0xFF); b.push_back((v >> 24) & 0xFF);
}
void put_u64(std::vector<uint8_t>& b, uint64_t v) {
  for (int i = 0; i < 8; i++) b.push_back((v >> (8 * i)) & 0xFF);
}
uint32_t get_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint64_t get_u64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}

// Record frame: u32 magic | u32 body_len | u32 body_crc | body.
// Body: u8 type | type-specific fields.
void frame(std::vector<uint8_t>& out, const std::vector<uint8_t>& body) {
  put_u32(out, kMagic);
  put_u32(out, (uint32_t)body.size());
  put_u32(out, crc32(body.data(), body.size()));
  out.insert(out.end(), body.begin(), body.end());
}

bool open_segment(Wal& w, uint32_t id, bool fresh) {
  if (w.fd >= 0) { ::close(w.fd); w.fd = -1; }
  std::string p = seg_path(w, id);
  int flags = O_CREAT | O_WRONLY | (fresh ? O_TRUNC : O_APPEND);
  int fd = ::open(p.c_str(), flags, 0644);
  if (fd < 0) { w.err = "open " + p + ": " + std::strerror(errno); return false; }
  w.fd = fd;
  w.seg_id = id;
  struct stat st;
  w.seg_off = (!fresh && ::fstat(fd, &st) == 0) ? (uint64_t)st.st_size : 0;
  if (fresh || std::find(w.live_segs.begin(), w.live_segs.end(), id) ==
                   w.live_segs.end())
    w.live_segs.push_back(id);
  return true;
}

// Apply one record body to an in-memory index.  `seg`/`payload_off` locate
// ENTRY payload bytes for later pread.  Parametrized over the group map so
// the GC worker can replay frozen segments into a PRIVATE map without
// touching the live engine state.
bool apply_body(GroupMap& groups, const uint8_t* b, uint32_t len, uint32_t seg,
                uint64_t payload_off_base) {
  if (len < 1) return false;
  uint8_t type = b[0];
  switch (type) {
    case kEntry: {
      if (len < 1 + 4 + 8 + 8 + 4) return false;
      uint32_t g = get_u32(b + 1);
      uint64_t idx = get_u64(b + 5);
      int64_t term = (int64_t)get_u64(b + 13);
      uint32_t plen = get_u32(b + 21);
      if (len != 1 + 4 + 8 + 8 + 4 + plen) return false;
      auto& gs = groups[g];
      gs.drop_suffix(idx);  // overwrite implies any old suffix at >= idx dies
      gs.entries[idx] = EntryRef{term, seg, payload_off_base + 25, plen};
      gs.tail = (int64_t)idx;
      return true;
    }
    case kStable: {
      if (len != 1 + 4 + 8 + 8) return false;
      uint32_t g = get_u32(b + 1);
      auto& gs = groups[g];
      gs.stable_term = (int64_t)get_u64(b + 5);
      gs.ballot = (int64_t)get_u64(b + 13);
      gs.has_stable = true;
      return true;
    }
    case kTruncate: {
      if (len != 1 + 4 + 8) return false;
      uint32_t g = get_u32(b + 1);
      groups[g].drop_suffix(get_u64(b + 5));
      return true;
    }
    case kMilestone: {
      if (len != 1 + 4 + 8 + 8) return false;
      uint32_t g = get_u32(b + 1);
      uint64_t idx = get_u64(b + 5);
      int64_t term = (int64_t)get_u64(b + 13);
      auto& gs = groups[g];
      // `>=` (not `>`): re-applying the current milestone must be a state
      // no-op INCLUDING its drop_prefix/tail-raise effects — the GC crash
      // window replays stale frozen segments AFTER the compacted base, and
      // a strict guard would let resurrected sub-floor entries survive.
      if ((int64_t)idx >= gs.floor) {
        gs.floor = (int64_t)idx;
        gs.floor_term = term;
        gs.drop_prefix(idx);
        if (gs.tail < gs.floor) gs.tail = gs.floor;
      }
      return true;
    }
    case kReset: {
      if (len != 1 + 4) return false;
      uint32_t g = get_u32(b + 1);
      groups.erase(g);  // a later open of this lane starts from scratch
      return true;
    }
    default:
      return false;
  }
}

// Replay one segment file into `groups`.  `fix_tail` truncates the file
// after a torn/corrupt tail (recovery behavior); the GC worker replays
// fsynced frozen segments read-only and passes false.
bool replay_segment_into(const std::string& dir, GroupMap& groups,
                         uint32_t id, bool fix_tail) {
  std::string p = seg_path_in(dir, id);
  int fd = ::open(p.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  ::fstat(fd, &st);
  std::vector<uint8_t> data((size_t)st.st_size);
  ssize_t rd = data.empty() ? 0 : ::pread(fd, data.data(), data.size(), 0);
  ::close(fd);
  if (rd < 0) return false;
  size_t n = (size_t)rd, off = 0;
  while (off + 12 <= n) {
    if (get_u32(&data[off]) != kMagic) break;           // torn tail
    uint32_t blen = get_u32(&data[off + 4]);
    uint32_t crc = get_u32(&data[off + 8]);
    if (off + 12 + blen > n) break;                     // torn tail
    if (crc32(&data[off + 12], blen) != crc) break;     // corrupt tail
    apply_body(groups, &data[off + 12], blen, id, off + 12);
    off += 12 + blen;
  }
  // If a torn tail was detected, truncate the file to the valid prefix so
  // future appends don't interleave with garbage.
  if (fix_tail && off < n) ::truncate(p.c_str(), (off_t)off);
  return true;
}

bool replay_segment(Wal& w, uint32_t id) {
  return replay_segment_into(w.dir, w.groups, id, /*fix_tail=*/true);
}

bool flush_buf(Wal& w) {
  if (w.poisoned) {
    if (w.err.empty()) w.err = "wal poisoned";
    return false;
  }
  if (w.buf.empty()) return true;
  if (fault_fire(w.fault_short_after)) {
    // Injected torn write: a prefix of the staged records lands on disk,
    // then the device "fails".  Poisons like any non-ENOSPC write error;
    // recovery's CRC framing truncates the torn tail on reopen.
    size_t keep = (size_t)std::min<int64_t>(
        std::max<int64_t>(w.fault_short_keep, 0), (int64_t)w.buf.size());
    size_t off = 0;
    while (off < keep) {
      ssize_t wr = ::write(w.fd, w.buf.data() + off, keep - off);
      if (wr < 0) break;
      off += (size_t)wr;
    }
    w.err = "injected short write";
    w.last_errno = EIO;
    w.poisoned = true;
    return false;
  }
  int inj = fault_fire(w.fault_write_after) ? (int)w.fault_write_errno : 0;
  size_t off = 0;
  while (off < w.buf.size()) {
    ssize_t wr =
        inj ? -1 : ::write(w.fd, w.buf.data() + off, w.buf.size() - off);
    if (wr < 0) {
      int e = inj ? inj : errno;
      w.err = std::strerror(e);
      w.last_errno = e;
      if (e == ENOSPC) {
        // Disk full is the one RETRIABLE write failure: rewind the segment
        // to the last known-good offset (a partial flush may have landed)
        // and keep the buffer so a later barrier retries once space frees.
        // Fresh segments are opened without O_APPEND, so the file offset
        // must be walked back alongside the truncate.
        ::ftruncate(w.fd, (off_t)w.seg_off);
        ::lseek(w.fd, (off_t)w.seg_off, SEEK_SET);
      } else {
        w.poisoned = true;
      }
      return false;
    }
    off += (size_t)wr;
  }
  w.seg_off += w.buf.size();
  w.buf.clear();
  return true;
}

void maybe_rotate(Wal& w) {
  if (w.seg_off + w.buf.size() < w.segment_bytes) return;
  if (!flush_buf(w)) return;  // surfaces at the sync barrier
  if (::fsync(w.fd) != 0) {
    int e = errno;
    w.err = std::string("fsync: ") + std::strerror(e);
    w.last_errno = e;
    w.poisoned = true;  // never retry fsync on a failed fd
    return;
  }
  open_segment(w, w.seg_id + 1, true);
}

double mono_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

// Record-level bodies shared by the serial entry points and the native host
// tier (wal_stage_and_sync): one implementation per record type keeps the
// two paths byte-identical by construction.
void do_truncate(Wal& w, uint32_t group, uint64_t from) {
  std::vector<uint8_t> body;
  body.push_back(kTruncate);
  put_u32(body, group);
  put_u64(body, from);
  w.groups[group].drop_suffix(from);
  frame(w.buf, body);
  maybe_rotate(w);
}

void do_milestone(Wal& w, uint32_t group, uint64_t index, int64_t term) {
  std::vector<uint8_t> body;
  body.push_back(kMilestone);
  put_u32(body, group);
  put_u64(body, index);
  put_u64(body, (uint64_t)term);
  auto& gs = w.groups[group];
  if ((int64_t)index >= gs.floor) {  // mirror apply_body's replay semantics
    gs.floor = (int64_t)index;
    gs.floor_term = term;
    gs.drop_prefix(index);
    if (gs.tail < gs.floor) gs.tail = gs.floor;
  }
  frame(w.buf, body);
  maybe_rotate(w);
}

// Shared bulk-entry staging loop (hot path): records are framed IN PLACE
// into the write buffer (no per-entry body vector; the CRC chains over
// header and payload without a copy) and the in-memory index exploits the
// staging order — entries arrive as ascending contiguous runs per group, so
// after one drop_suffix at a run's head every insert is an O(1) hinted
// emplace at map end instead of an O(log n) search.  `ptr_at(i)` resolves
// row i's payload bytes, letting the blob-offset ABI (wal_append_entries)
// and the raw-pointer ABI (wal_stage_and_sync) share one byte-identical
// implementation.
template <typename PtrAt>
void stage_rows_impl(Wal& w, uint64_t n, const uint32_t* groups,
                     const uint64_t* idxs, const int64_t* terms,
                     const uint32_t* lens, PtrAt ptr_at) {
  if (n == 0) return;
  const double stat_t0 = mono_s();
  uint64_t total = 0;
  for (uint64_t i = 0; i < n; i++) total += 37u + (uint64_t)lens[i];
  w.buf.reserve(w.buf.size() + total);
  uint8_t hdr[25];
  hdr[0] = kEntry;
  GroupState* gs = nullptr;
  uint32_t cur_g = 0;
  uint64_t prev_idx = 0;
  bool run_live = false;
  for (uint64_t i = 0; i < n; i++) {
    const uint32_t g = groups[i];
    const uint64_t idx = idxs[i];
    const uint32_t plen = lens[i];
    const uint8_t* p = ptr_at(i);
    // body header (little-endian, layout matches wal_append_entry)
    hdr[1] = (uint8_t)g; hdr[2] = (uint8_t)(g >> 8);
    hdr[3] = (uint8_t)(g >> 16); hdr[4] = (uint8_t)(g >> 24);
    for (int b = 0; b < 8; b++) hdr[5 + b] = (uint8_t)(idx >> (8 * b));
    const uint64_t t = (uint64_t)terms[i];
    for (int b = 0; b < 8; b++) hdr[13 + b] = (uint8_t)(t >> (8 * b));
    hdr[21] = (uint8_t)plen; hdr[22] = (uint8_t)(plen >> 8);
    hdr[23] = (uint8_t)(plen >> 16); hdr[24] = (uint8_t)(plen >> 24);
    const uint32_t crc = crc32(p, plen, crc32(hdr, 25));
    put_u32(w.buf, kMagic);
    put_u32(w.buf, 25u + plen);
    put_u32(w.buf, crc);
    const uint64_t body_off = w.seg_off + w.buf.size();
    w.buf.insert(w.buf.end(), hdr, hdr + 25);
    if (plen) w.buf.insert(w.buf.end(), p, p + plen);
    // index update (mirrors wal_append_entry/replay semantics)
    if (gs == nullptr || g != cur_g) {
      gs = &w.groups[g];
      cur_g = g;
      run_live = false;
    }
    if (run_live && idx == prev_idx + 1) {
      gs->entries.emplace_hint(gs->entries.end(), idx,
                               EntryRef{terms[i], w.seg_id, body_off + 25,
                                        plen});
    } else {
      gs->drop_suffix(idx);
      gs->entries[idx] = EntryRef{terms[i], w.seg_id, body_off + 25, plen};
      run_live = true;
    }
    gs->tail = (int64_t)idx;
    prev_idx = idx;
    if (w.seg_off + w.buf.size() >= w.segment_bytes) {
      maybe_rotate(w);
      gs = nullptr;  // rotation does not move the map, but re-resolve for
                     // clarity; the payload refs already recorded keep
                     // their (seg, off) and are unaffected.
    }
  }
  w.stat_stage_ns.fetch_add((uint64_t)((mono_s() - stat_t0) * 1e9),
                            std::memory_order_relaxed);
  w.stat_bytes.fetch_add(total, std::memory_order_relaxed);
  w.stat_stage_calls.fetch_add(1, std::memory_order_relaxed);
}

// Split [0, n_items) into one contiguous chunk per worker; worker 0 runs
// inline on the calling thread.  `f(c0, c1)` must be thread-safe for
// disjoint ranges.
template <typename F>
void run_ranges(uint32_t n_workers, uint64_t n_items, F&& f) {
  if (n_workers <= 1 || n_items < (uint64_t)n_workers * 4) {
    f((uint64_t)0, n_items);
    return;
  }
  uint64_t chunk = (n_items + n_workers - 1) / n_workers;
  std::vector<std::thread> ts;
  for (uint64_t c0 = chunk; c0 < n_items; c0 += chunk) {
    uint64_t c1 = std::min(n_items, c0 + chunk);
    ts.emplace_back([&f, c0, c1]() { f(c0, c1); });
  }
  f((uint64_t)0, chunk);
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

void* wal_open(const char* dir, uint64_t segment_bytes) {
  Wal* w = new Wal();
  w->dir = dir;
  w->segment_bytes = segment_bytes ? segment_bytes : (64u << 20);
  ::mkdir(dir, 0755);
  // A leftover compaction temp from a crash mid-GC is garbage: the frozen
  // segments it was built from are still live (gc_finish renames before it
  // unlinks), so recovery replays them and the tmp is simply re-derived.
  ::unlink((w->dir + "/gc.tmp").c_str());
  // Discover and replay segments in ascending id order.
  std::vector<uint32_t> segs;
  if (DIR* d = ::opendir(dir)) {
    while (dirent* e = ::readdir(d)) {
      unsigned id;
      if (std::sscanf(e->d_name, "%8u.wal", &id) == 1) segs.push_back(id);
    }
    ::closedir(d);
  }
  std::sort(segs.begin(), segs.end());
  for (uint32_t id : segs) {
    replay_segment(*w, id);
    w->live_segs.push_back(id);
  }
  uint32_t next = segs.empty() ? 0 : segs.back();
  if (!open_segment(*w, next, segs.empty())) { delete w; return nullptr; }
  return w;
}

void wal_close(void* h) {
  Wal* w = (Wal*)h;
  if (!w) return;
  flush_buf(*w);
  if (w->fd >= 0) { ::fsync(w->fd); ::close(w->fd); }
  delete w;
}

// -- writes (buffered; durable after wal_sync) ------------------------------

void wal_append_entry(void* h, uint32_t group, uint64_t index, int64_t term,
                      const uint8_t* payload, uint32_t plen) {
  Wal* w = (Wal*)h;
  std::vector<uint8_t> body;
  body.reserve(25 + plen);
  body.push_back(kEntry);
  put_u32(body, group);
  put_u64(body, index);
  put_u64(body, (uint64_t)term);
  put_u32(body, plen);
  if (plen) body.insert(body.end(), payload, payload + plen);
  // Index update mirrors replay so reads see the write immediately; the
  // payload ref points into the open segment at its post-flush offset.
  uint64_t body_off = w->seg_off + w->buf.size() + 12;
  auto& gs = w->groups[group];
  gs.drop_suffix(index);
  gs.entries[index] = EntryRef{term, w->seg_id, body_off + 25, plen};
  gs.tail = (int64_t)index;
  frame(w->buf, body);
  w->stat_bytes.fetch_add(12u + 25u + (uint64_t)plen,
                          std::memory_order_relaxed);
  w->stat_stage_calls.fetch_add(1, std::memory_order_relaxed);
  maybe_rotate(*w);
}

void wal_append_stable(void* h, uint32_t group, int64_t term, int64_t ballot) {
  Wal* w = (Wal*)h;
  std::vector<uint8_t> body;
  body.push_back(kStable);
  put_u32(body, group);
  put_u64(body, (uint64_t)term);
  put_u64(body, (uint64_t)ballot);
  auto& gs = w->groups[group];
  gs.stable_term = term;
  gs.ballot = ballot;
  gs.has_stable = true;
  frame(w->buf, body);
  maybe_rotate(*w);
}

void wal_truncate(void* h, uint32_t group, uint64_t from) {
  do_truncate(*(Wal*)h, group, from);
}

void wal_milestone(void* h, uint32_t group, uint64_t index, int64_t term) {
  do_milestone(*(Wal*)h, group, index, term);
}

// Group destroyed (admin lifecycle): journal a RESET so the lane's entire
// durable state — entries, stable record, milestone — is forgotten, letting
// a future group reuse the lane from scratch (the reference deletes the
// group's RocksDB directory, command/storage/RocksStateLoader.java:48-59).
void wal_reset(void* h, uint32_t group) {
  Wal* w = (Wal*)h;
  std::vector<uint8_t> body;
  body.push_back(kReset);
  put_u32(body, group);
  w->groups.erase(group);
  frame(w->buf, body);
  maybe_rotate(*w);
}

// Flush buffered records and fsync — the durability barrier.  One call per
// node tick covers every group (group commit).
int wal_sync(void* h) {
  Wal* w = (Wal*)h;
  if (w->poisoned) return -1;  // fail-stop: never fsync a failed fd again
  // Timed from here so injected sync delays (the slow-I/O gray-failure
  // simulation) show up in stat_fsync_ns exactly as a real slow disk would.
  const double stat_t0 = mono_s();
  if (w->sync_delay_us > 0) ::usleep((useconds_t)w->sync_delay_us);
  if (!flush_buf(*w)) return -1;
  if (fault_fire(w->fault_fsync_after)) {
    w->err = "injected fsync failure";
    w->last_errno = (int)w->fault_fsync_errno;
    w->poisoned = true;
    return -1;
  }
  if (::fsync(w->fd) != 0) {
    int e = errno;
    w->err = std::string("fsync: ") + std::strerror(e);
    w->last_errno = e;
    w->poisoned = true;
    return -1;
  }
  w->stat_fsync_ns.fetch_add((uint64_t)((mono_s() - stat_t0) * 1e9),
                             std::memory_order_relaxed);
  w->stat_fsync_calls.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

// -- reads ------------------------------------------------------------------

int64_t wal_tail(void* h, uint32_t group) {
  Wal* w = (Wal*)h;
  auto it = w->groups.find(group);
  return it == w->groups.end() ? 0 : it->second.tail;
}
int64_t wal_floor(void* h, uint32_t group) {
  Wal* w = (Wal*)h;
  auto it = w->groups.find(group);
  return it == w->groups.end() ? 0 : it->second.floor;
}
int64_t wal_floor_term(void* h, uint32_t group) {
  Wal* w = (Wal*)h;
  auto it = w->groups.find(group);
  return it == w->groups.end() ? 0 : it->second.floor_term;
}
int wal_stable(void* h, uint32_t group, int64_t* term, int64_t* ballot) {
  Wal* w = (Wal*)h;
  auto it = w->groups.find(group);
  if (it == w->groups.end() || !it->second.has_stable) return 0;
  *term = it->second.stable_term;
  *ballot = it->second.ballot;
  return 1;
}
// Entry term at index, or -1 if absent (floor itself reports floor_term).
int64_t wal_entry_term(void* h, uint32_t group, uint64_t index) {
  Wal* w = (Wal*)h;
  auto git = w->groups.find(group);
  if (git == w->groups.end()) return -1;
  auto& gs = git->second;
  if ((int64_t)index == gs.floor) return gs.floor_term;
  auto it = gs.entries.find(index);
  return it == gs.entries.end() ? -1 : it->second.term;
}
int64_t wal_entry_len(void* h, uint32_t group, uint64_t index) {
  Wal* w = (Wal*)h;
  auto git = w->groups.find(group);
  if (git == w->groups.end()) return -1;
  auto it = git->second.entries.find(index);
  return it == git->second.entries.end() ? -1 : (int64_t)it->second.len;
}
// Copy payload into caller buffer; returns bytes copied or -1.
int64_t wal_entry_payload(void* h, uint32_t group, uint64_t index,
                          uint8_t* out, uint64_t cap) {
  Wal* w = (Wal*)h;
  auto git = w->groups.find(group);
  if (git == w->groups.end()) return -1;
  auto it = git->second.entries.find(index);
  if (it == git->second.entries.end()) return -1;
  const EntryRef& r = it->second;
  if (r.len > cap) return -1;
  if (r.len == 0) return 0;
  if (r.seg == w->seg_id && r.off >= w->seg_off) {
    // Still in the unflushed buffer.
    size_t boff = (size_t)(r.off - w->seg_off);
    if (boff + r.len > w->buf.size()) return -1;
    std::memcpy(out, w->buf.data() + boff, r.len);
    return r.len;
  }
  std::string p = seg_path(*w, r.seg);
  int fd = ::open(p.c_str(), O_RDONLY);
  if (fd < 0) return -1;
  ssize_t rd = ::pread(fd, out, r.len, (off_t)r.off);
  ::close(fd);
  return rd == (ssize_t)r.len ? rd : -1;
}

uint64_t wal_group_count(void* h) { return ((Wal*)h)->groups.size(); }
uint64_t wal_segment_count(void* h) { return ((Wal*)h)->live_segs.size(); }

// On-disk footprint of all live segments + the unflushed buffer.  Stats the
// files (cheap at GC-policy cadence) so the figure survives restart.
uint64_t wal_total_bytes(void* h) {
  Wal* w = (Wal*)h;
  uint64_t total = w->buf.size();
  struct stat st;
  for (uint32_t id : w->live_segs)
    if (::stat(seg_path(*w, id).c_str(), &st) == 0)
      total += (uint64_t)st.st_size;
  return total;
}

// Bytes a checkpoint rewrite would carry: live entries (frame + body + payload)
// plus per-group stable/milestone records.  total_bytes / live_bytes is the
// GC trigger ratio (the dead fraction — entries superseded by overwrite,
// truncation, compaction or reset — is what GC reclaims).
uint64_t wal_live_bytes(void* h) {
  Wal* w = (Wal*)h;
  uint64_t live = 0;
  for (auto& kv : w->groups) {
    const GroupState& gs = kv.second;
    if (gs.has_stable) live += 12 + 21;
    if (gs.floor > 0) live += 12 + 21;
    for (auto& er : gs.entries) live += 12 + 25 + er.second.len;
  }
  return live;
}

// List group ids into caller buffer; returns count written.
uint64_t wal_groups(void* h, uint32_t* out, uint64_t cap) {
  Wal* w = (Wal*)h;
  uint64_t n = 0;
  for (auto& kv : w->groups) {
    if (n >= cap) break;
    out[n++] = kv.first;
  }
  return n;
}

// Bulk state export for boot-time restore (the vectorized analog of the
// reference's per-group RaftContext.initialize restore walk,
// context/RaftContext.java:91-113): one call fills per-group arrays for
// groups [0, G) plus the [G, L] ring of live entry terms (slot = idx % L
// for idx in (floor, tail]).  live_count[g] lets the caller verify
// contiguity (expected = tail - floor) without a per-entry Python loop.
uint64_t wal_export_state(void* h, uint32_t G, uint32_t L,
                          int64_t* stable_term, int64_t* ballot,
                          uint8_t* has_stable, int64_t* floor_out,
                          int64_t* floor_term, int64_t* tail,
                          int64_t* live_count, int32_t* ring) {
  Wal* w = (Wal*)h;
  uint64_t n = 0;
  for (auto& kv : w->groups) {
    uint32_t g = kv.first;
    if (g >= G) continue;
    GroupState& gs = kv.second;
    stable_term[g] = gs.stable_term;
    ballot[g] = gs.ballot;
    has_stable[g] = gs.has_stable ? 1 : 0;
    floor_out[g] = gs.floor;
    floor_term[g] = gs.floor_term;
    tail[g] = gs.tail;
    int64_t cnt = 0;
    for (auto& er : gs.entries) {
      int64_t idx = (int64_t)er.first;
      if (idx > gs.floor && idx <= gs.tail) {
        if (ring) ring[(uint64_t)g * L + (er.first % L)] =
            (int32_t)er.second.term;
        cnt++;
      }
    }
    live_count[g] = cnt;
    n++;
  }
  return n;
}

// Batched append: n entries across any mix of groups in ONE call, payload
// bytes concatenated in `payloads` at offsets `offs` (the host runtime
// stages a whole tick's writes and crosses the ctypes boundary once).
// Hot path of the durable tier; see stage_rows_impl for the framing and
// index discipline.
void wal_append_entries(void* h, uint64_t n, const uint32_t* groups,
                        const uint64_t* idxs, const int64_t* terms,
                        const uint8_t* payloads, const uint64_t* offs,
                        const uint32_t* lens) {
  stage_rows_impl(*(Wal*)h, n, groups, idxs, terms, lens,
                  [&](uint64_t i) { return payloads + offs[i]; });
}

// Rewrite all live state into a fresh segment and delete older segments —
// the compaction/GC pass (the reference's RocksDB deleteRange + snapshot
// retention analog, RocksLog.java:228-242).
int wal_checkpoint(void* h) {
  Wal* w = (Wal*)h;
  if (w->gc.pending) return -1;  // three-phase GC owns the frozen segments
  if (!flush_buf(*w)) return -1;
  ::fsync(w->fd);
  uint32_t new_id = w->seg_id + 1;
  std::vector<uint32_t> old_segs = w->live_segs;
  if (!open_segment(*w, new_id, true)) return -1;
  // Track only segments written from here on (rotation during the rewrite
  // may add more); everything in old_segs dies afterwards.
  w->live_segs.assign(1, new_id);
  // Re-emit live records; payload bytes are read via the OLD refs before
  // the index is repointed.
  for (auto& kv : w->groups) {
    uint32_t g = kv.first;
    GroupState& gs = kv.second;
    if (gs.has_stable) wal_append_stable(h, g, gs.stable_term, gs.ballot);
    if (gs.floor > 0) {
      std::vector<uint8_t> body;
      body.push_back(kMilestone);
      put_u32(body, g);
      put_u64(body, (uint64_t)gs.floor);
      put_u64(body, (uint64_t)gs.floor_term);
      frame(w->buf, body);
    }
    // Copy entries (iterate over a snapshot of refs; wal_append_entry
    // mutates the map).
    std::vector<std::pair<uint64_t, EntryRef>> ents(gs.entries.begin(),
                                                    gs.entries.end());
    for (auto& er : ents) {
      std::vector<uint8_t> payload(er.second.len);
      if (er.second.len) {
        std::string p = seg_path(*w, er.second.seg);
        int fd = ::open(p.c_str(), O_RDONLY);
        if (fd < 0) return -1;
        ssize_t rd = ::pread(fd, payload.data(), er.second.len,
                             (off_t)er.second.off);
        ::close(fd);
        if (rd != (ssize_t)er.second.len) return -1;
      }
      wal_append_entry(h, g, er.first, er.second.term, payload.data(),
                       er.second.len);
    }
  }
  if (!flush_buf(*w)) return -1;
  if (::fsync(w->fd) != 0) return -1;
  for (uint32_t id : old_segs)
    if (std::find(w->live_segs.begin(), w->live_segs.end(), id) ==
        w->live_segs.end())
      ::unlink(seg_path(*w, id).c_str());
  return 0;
}

// ---------------------------------------------------------------------------
// Three-phase GC: bounded tick-thread latency (VERDICT r2 #6 — the full
// wal_checkpoint rewrite on the tick thread is a multi-second stall at scale;
// the reference reclaims off the consensus path via RocksDB deleteRange +
// background compaction, command/storage/RocksLog.java:228-242).
//
//   gc_begin   (tick thread, O(1)):  seal + rotate; freeze prior segments.
//   gc_rewrite (worker thread):      replay the frozen files into a PRIVATE
//                                    index, write a compacted base to gc.tmp,
//                                    build the payload-repoint table.  Shares
//                                    no mutable state with the live engine.
//   gc_finish  (tick thread, O(live entries), memory-only + rename/unlink):
//                                    verify coverage, swap the base in under
//                                    the first frozen id, repoint EntryRefs,
//                                    drop the rest of the frozen set.
//
// Correctness of the swap: the base carries the frozen prefix's compacted
// state under id frozen[0], which sorts BEFORE every segment written after
// gc_begin — so recovery replay order (base, then post-begin segments)
// reproduces exactly the live state.  A crash between rename and the
// unlinks re-replays surviving frozen segments after the base, which is a
// no-op (each record reasserts state the base already contains or a later
// record overrides).
// ---------------------------------------------------------------------------

int wal_gc_begin(void* h) {
  Wal* w = (Wal*)h;
  if (w->gc.pending) return -1;
  if (!flush_buf(*w)) return -1;
  if (::fsync(w->fd) != 0) return -1;
  w->gc.frozen = w->live_segs;           // everything sealed so far
  w->gc.repoint.clear();
  w->gc.rewritten = false;
  if (!open_segment(*w, w->seg_id + 1, true)) return -1;
  w->gc.pending = true;
  return (int)w->gc.frozen.size();
}

// Worker-thread safe: reads only dir + the frozen file set (immutable while
// pending) and writes only gc.repoint/gc.rewritten (tick thread reads them
// only in gc_finish, after the caller observed rewrite completion).
int64_t wal_gc_rewrite(void* h) {
  Wal* w = (Wal*)h;
  if (!w->gc.pending || w->gc.rewritten) return -1;
  GroupMap priv;
  for (uint32_t id : w->gc.frozen)
    if (!replay_segment_into(w->dir, priv, id, /*fix_tail=*/false)) return -1;

  std::string tmp_path = w->dir + "/gc.tmp";
  int fd = ::open(tmp_path.c_str(), O_CREAT | O_WRONLY | O_TRUNC, 0644);
  if (fd < 0) return -1;
  // Source-segment fd cache: live entries cluster in a handful of frozen
  // segments; one open per segment, not per entry.
  std::unordered_map<uint32_t, int> src_fds;
  auto close_all = [&]() {
    for (auto& kv : src_fds) ::close(kv.second);
    ::close(fd);
  };
  std::vector<uint8_t> out;
  out.reserve(1 << 20);
  uint64_t written = 0;
  auto flush_out = [&]() -> bool {
    size_t off = 0;
    while (off < out.size()) {
      ssize_t wr = ::write(fd, out.data() + off, out.size() - off);
      if (wr < 0) return false;
      off += (size_t)wr;
    }
    written += out.size();
    out.clear();
    return true;
  };
  for (auto& kv : priv) {
    uint32_t g = kv.first;
    GroupState& gs = kv.second;
    if (gs.has_stable) {
      std::vector<uint8_t> body;
      body.push_back(kStable);
      put_u32(body, g);
      put_u64(body, (uint64_t)gs.stable_term);
      put_u64(body, (uint64_t)gs.ballot);
      frame(out, body);
    }
    if (gs.floor > 0) {
      std::vector<uint8_t> body;
      body.push_back(kMilestone);
      put_u32(body, g);
      put_u64(body, (uint64_t)gs.floor);
      put_u64(body, (uint64_t)gs.floor_term);
      frame(out, body);
    }
    for (auto& er : gs.entries) {
      std::vector<uint8_t> payload(er.second.len);
      if (er.second.len) {
        int sfd;
        auto fit = src_fds.find(er.second.seg);
        if (fit != src_fds.end()) {
          sfd = fit->second;
        } else {
          sfd = ::open(seg_path_in(w->dir, er.second.seg).c_str(), O_RDONLY);
          if (sfd < 0) { close_all(); return -1; }
          src_fds[er.second.seg] = sfd;
        }
        ssize_t rd = ::pread(sfd, payload.data(), er.second.len,
                             (off_t)er.second.off);
        if (rd != (ssize_t)er.second.len) { close_all(); return -1; }
      }
      std::vector<uint8_t> body;
      body.reserve(25 + er.second.len);
      body.push_back(kEntry);
      put_u32(body, g);
      put_u64(body, er.first);
      put_u64(body, (uint64_t)er.second.term);
      put_u32(body, er.second.len);
      body.insert(body.end(), payload.begin(), payload.end());
      // Payload lands at: frames so far + frame header (12) + body prefix (25).
      uint64_t payload_off = written + out.size() + 12 + 25;
      frame(out, body);
      w->gc.repoint.push_back(
          GcRepoint{g, er.first, er.second.term, payload_off, er.second.len});
      if (out.size() > (1u << 20) && !flush_out()) { close_all(); return -1; }
    }
  }
  if (!flush_out()) { close_all(); return -1; }
  if (::fsync(fd) != 0) { close_all(); return -1; }
  close_all();
  w->gc.rewritten = true;
  return (int64_t)written;
}

int wal_gc_finish(void* h) {
  Wal* w = (Wal*)h;
  if (!w->gc.pending || !w->gc.rewritten) return -1;
  std::unordered_set<uint32_t> frozen(w->gc.frozen.begin(),
                                      w->gc.frozen.end());
  uint32_t base_id = w->gc.frozen.front();

  // Coverage check BEFORE any destructive step: every live payload ref into
  // the frozen set must have a matching repoint row, else the base misses
  // data and the swap would corrupt reads.  (Cannot happen by construction —
  // any ref still pointing into frozen was last written there and therefore
  // replayed — but a cheap memory-only walk buys a hard guarantee.)
  uint64_t frozen_refs = 0, matched = 0;
  for (auto& kv : w->groups)
    for (auto& er : kv.second.entries)
      if (frozen.count(er.second.seg)) frozen_refs++;
  for (auto& rp : w->gc.repoint) {
    auto git = w->groups.find(rp.g);
    if (git == w->groups.end()) continue;
    auto it = git->second.entries.find(rp.idx);
    if (it != git->second.entries.end() && frozen.count(it->second.seg) &&
        it->second.term == rp.term)
      matched++;
  }
  if (matched != frozen_refs) { w->err = "gc coverage mismatch"; return -2; }

  // Durable swap: base file takes the first frozen id (sorts before every
  // post-begin segment), then the rest of the frozen set dies.
  std::string tmp_path = w->dir + "/gc.tmp";
  if (::rename(tmp_path.c_str(), seg_path(*w, base_id).c_str()) != 0) {
    w->err = std::string("gc rename: ") + std::strerror(errno);
    return -1;
  }
  if (int dfd = ::open(w->dir.c_str(), O_RDONLY); dfd >= 0) {
    ::fsync(dfd);  // make the rename itself durable
    ::close(dfd);
  }
  // Repoint live refs into the base.
  for (auto& rp : w->gc.repoint) {
    auto git = w->groups.find(rp.g);
    if (git == w->groups.end()) continue;
    auto it = git->second.entries.find(rp.idx);
    if (it != git->second.entries.end() && frozen.count(it->second.seg) &&
        it->second.term == rp.term)
      it->second = EntryRef{rp.term, base_id, rp.off, rp.len};
  }
  for (uint32_t id : w->gc.frozen)
    if (id != base_id) ::unlink(seg_path(*w, id).c_str());
  std::vector<uint32_t> segs;
  segs.push_back(base_id);
  for (uint32_t id : w->live_segs)
    if (!frozen.count(id)) segs.push_back(id);
  w->live_segs = std::move(segs);
  w->gc = GcState();
  return 0;
}

// Abandon a pending GC (worker failed / shutdown): drop the temp, keep the
// frozen segments live.  Always safe — nothing was swapped.
void wal_gc_abort(void* h) {
  Wal* w = (Wal*)h;
  ::unlink((w->dir + "/gc.tmp").c_str());
  w->gc = GcState();
}

const char* wal_error(void* h) { return ((Wal*)h)->err.c_str(); }

// -- injectable fault table (testkit/faultfs) -------------------------------
// op: 1=fsync-fail 2=write-fail 3=short-write 4=sync-delay.  `after` counts
// guarded calls before firing (0 = next call); `value` is an errno for ops
// 1/2 (0 -> EIO), bytes kept for op 3, microseconds for op 4 (op 4 is a
// level, not a countdown).  Clearing disarms countdowns but does NOT heal
// `poisoned`: fail-stop latches for the handle lifetime.

int wal_fault_set(void* h, int op, int64_t after, int64_t value) {
  Wal* w = (Wal*)h;
  switch (op) {
    case 1:
      w->fault_fsync_after = after;
      w->fault_fsync_errno = value ? value : EIO;
      return 0;
    case 2:
      w->fault_write_after = after;
      w->fault_write_errno = value ? value : EIO;
      return 0;
    case 3:
      w->fault_short_after = after;
      w->fault_short_keep = value;
      return 0;
    case 4:
      w->sync_delay_us = value;
      return 0;
  }
  return -1;
}

void wal_fault_clear(void* h) {
  Wal* w = (Wal*)h;
  w->fault_fsync_after = -1;
  w->fault_write_after = -1;
  w->fault_short_after = -1;
  w->sync_delay_us = 0;
}

int wal_poisoned(void* h) { return ((Wal*)h)->poisoned ? 1 : 0; }

int wal_last_errno(void* h) { return ((Wal*)h)->last_errno; }

// Zero-copy stats export: fill the caller's 7-slot u64 buffer with this
// handle's cumulative {stage_ns, fsync_ns, pack_ns, bytes, stage_calls,
// fsync_calls, pack_calls}.  Counters are never reset — the Python side
// keeps the last snapshot and folds deltas into the metrics registry.
void wal_stats(void* h, uint64_t* out) {
  Wal* w = (Wal*)h;
  out[0] = w->stat_stage_ns.load(std::memory_order_relaxed);
  out[1] = w->stat_fsync_ns.load(std::memory_order_relaxed);
  out[2] = w->stat_pack_ns.load(std::memory_order_relaxed);
  out[3] = w->stat_bytes.load(std::memory_order_relaxed);
  out[4] = w->stat_stage_calls.load(std::memory_order_relaxed);
  out[5] = w->stat_fsync_calls.load(std::memory_order_relaxed);
  out[6] = w->stat_pack_calls.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// Native host tier: the per-stripe persist hot loop behind ONE ctypes call.
//
// The striped Python worker pool (runtime/node.py _host_phase_striped) tops
// out near 1.15x because its workers only overlap the GIL-released syscalls;
// the staging loops themselves serialize on the interpreter.  These entry
// points move the whole stage → fsync → pack pipeline into real OS threads:
// ctypes releases the GIL for the duration of the call, worker k owns WAL
// shards `s % n_workers == k` (the exact ownership map of the Python pool,
// so per-shard record order — and therefore segment bytes — is identical),
// and the tick thread becomes pure orchestration.
//
// Handles must be distinct single-threaded engines (one per shard); within
// a call each shard is touched by exactly one worker, and no other thread
// may use the handles concurrently — the same contract the Python striped
// pool already upholds.
// ---------------------------------------------------------------------------

// Stage one tick's durable work across all shards and (optionally) fsync.
//
// Entry rows are pre-sorted by shard (stable, so the caller's per-group
// ascending contiguous runs survive); `row_off[s]..row_off[s+1]` is shard
// s's slice.  Payload bytes live at caller-supplied absolute addresses
// (`ptrs`, one per row — numpy arena views handed straight through, no blob
// join).  Truncations (`t*`) and milestones (`f*`) use the same per-shard
// CSR layout and are applied AFTER the shard's entries, matching the serial
// path's record order (stable records are staged by the caller before this
// call).  `do_sync=0` stages without the fsync barrier — the crash-window
// tests carve the torn-tail window with it.  Out-params receive the max
// per-worker stage and fsync wall times.
int wal_stage_and_sync(void** handles, uint32_t n_shards, uint32_t n_workers,
                       const uint64_t* row_off, const uint32_t* groups,
                       const uint64_t* idxs, const int64_t* terms,
                       const uint64_t* ptrs, const uint32_t* lens,
                       const uint64_t* trow_off, const uint32_t* tgroups,
                       const uint64_t* tfrom,
                       const uint64_t* frow_off, const uint32_t* fgroups,
                       const uint64_t* fidx, const int64_t* fterm,
                       int do_sync, double* stage_s, double* fsync_s) {
  if (!handles || n_shards == 0) return -1;
  if (n_workers == 0) n_workers = 1;
  if (n_workers > n_shards) n_workers = n_shards;
  std::vector<double> st(n_workers, 0.0), fs(n_workers, 0.0);
  std::vector<int> rc(n_workers, 0);
  auto work = [&](uint32_t k) {
    const double t0 = mono_s();
    for (uint32_t s = k; s < n_shards; s += n_workers) {
      Wal& w = *(Wal*)handles[s];
      const uint64_t r0 = row_off[s], r1 = row_off[s + 1];
      stage_rows_impl(w, r1 - r0, groups + r0, idxs + r0, terms + r0,
                      lens + r0,
                      [&, r0](uint64_t i) {
                        return (const uint8_t*)(uintptr_t)ptrs[r0 + i];
                      });
      for (uint64_t i = trow_off[s]; i < trow_off[s + 1]; i++)
        do_truncate(w, tgroups[i], tfrom[i]);
      for (uint64_t i = frow_off[s]; i < frow_off[s + 1]; i++)
        do_milestone(w, fgroups[i], fidx[i], fterm[i]);
    }
    const double t1 = mono_s();
    st[k] = t1 - t0;
    if (do_sync) {
      // One wal_sync per shard centralizes the failure policy: poisoned
      // engines fail fast, injected faults fire, and any fsync failure
      // latches `poisoned` exactly like the serial barrier.
      for (uint32_t s = k; s < n_shards; s += n_workers)
        if (wal_sync(handles[s]) != 0) rc[k] = -1;
      fs[k] = mono_s() - t1;
    }
  };
  if (n_workers == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    ts.reserve(n_workers - 1);
    for (uint32_t k = 1; k < n_workers; k++) ts.emplace_back(work, k);
    work(0);
    for (auto& t : ts) t.join();
  }
  if (stage_s) *stage_s = *std::max_element(st.begin(), st.end());
  if (fsync_s) *fsync_s = *std::max_element(fs.begin(), fs.end());
  for (int r : rc)
    if (r != 0) return -1;
  return 0;
}

namespace {

// Per-call mmap cache for flushed segment files (pack reads cluster in the
// open segment plus at most a handful of predecessors).
struct SegMap {
  uint8_t* p = nullptr;
  uint64_t size = 0;
  int fd = -1;
};
using SegMapCache = std::unordered_map<uint64_t, SegMap>;

bool copy_payload(Wal* w, uint32_t shard, const EntryRef& r, uint8_t* dst,
                  SegMapCache& maps) {
  if (r.len == 0) return true;
  if (r.seg == w->seg_id && r.off >= w->seg_off) {
    // Still in the unflushed buffer.  Safe to read concurrently: pack runs
    // strictly between staging phases, so no thread mutates the buffer.
    const size_t boff = (size_t)(r.off - w->seg_off);
    if (boff + r.len > w->buf.size()) return false;
    std::memcpy(dst, w->buf.data() + boff, r.len);
    return true;
  }
  const uint64_t key = ((uint64_t)shard << 32) | r.seg;
  auto it = maps.find(key);
  if (it == maps.end()) {
    SegMap sm;
    sm.fd = ::open(seg_path(*w, r.seg).c_str(), O_RDONLY);
    if (sm.fd < 0) return false;
    struct stat stt;
    if (::fstat(sm.fd, &stt) == 0) sm.size = (uint64_t)stt.st_size;
    if (sm.size) {
      void* mp = ::mmap(nullptr, sm.size, PROT_READ, MAP_SHARED, sm.fd, 0);
      if (mp != MAP_FAILED) sm.p = (uint8_t*)mp;
    }
    it = maps.emplace(key, sm).first;
  }
  const SegMap& sm = it->second;
  if (sm.p && r.off + r.len <= sm.size) {
    std::memcpy(dst, sm.p + r.off, r.len);
    return true;
  }
  return ::pread(sm.fd, dst, r.len, (off_t)r.off) == (ssize_t)r.len;
}

void drop_segmaps(SegMapCache& maps) {
  for (auto& kv : maps) {
    if (kv.second.p) ::munmap(kv.second.p, kv.second.size);
    if (kv.second.fd >= 0) ::close(kv.second.fd);
  }
  maps.clear();
}

// Total payload bytes for entries [start, start+n) of group g, or -1 if the
// range is not fully present (column gets dropped, exactly as the Python
// packer drops a column whose runs/window cannot cover it).
int64_t col_bytes(Wal* w, uint32_t g, uint64_t start, uint32_t n) {
  if (n == 0) return 0;
  auto git = w->groups.find(g);
  if (git == w->groups.end()) return -1;
  auto& ents = git->second.entries;
  auto it = ents.find(start);
  uint64_t sum = 0;
  for (uint32_t k = 0; k < n; k++, ++it) {
    if (it == ents.end() || it->first != start + k) return -1;
    sum += it->second.len;
  }
  return (int64_t)sum;
}

}  // namespace

// Pack the AppendEntries payload blob for n_cols columns: the u32 length
// vector for every kept column's entries, then the payload bytes — the
// byte-exact layout of codec.pack_kind_section's `blob_section`.  Columns
// whose range is absent get ok_out[c]=0 and contribute nothing (the caller
// drops/defers them like the Python packer).  Payloads are resolved from
// the engines' own indexes (unflushed buffer or mmap'd segments) with
// chunk-parallel workers; read-only over the maps, so safe to run while no
// staging is in flight.  Returns the malloc'd blob via *out_ptr (free with
// wal_buf_free) and its total length, or -1 on I/O failure (caller falls
// back to the Python pack path).
int64_t wal_pack_ae(void** handles, uint32_t n_shards, uint32_t n_workers,
                    uint64_t n_cols, const uint32_t* gs,
                    const uint64_t* starts, const uint32_t* ns,
                    uint8_t* ok_out, uint8_t** out_ptr) {
  if (!handles || n_shards == 0) return -1;
  *out_ptr = nullptr;
  std::vector<uint64_t> pay(n_cols, 0);
  run_ranges(n_workers, n_cols, [&](uint64_t c0, uint64_t c1) {
    for (uint64_t c = c0; c < c1; c++) {
      Wal* w = (Wal*)handles[gs[c] % n_shards];
      const int64_t b = col_bytes(w, gs[c], starts[c], ns[c]);
      ok_out[c] = b >= 0 ? 1 : 0;
      pay[c] = b >= 0 ? (uint64_t)b : 0;
    }
  });
  // Column offsets: kept columns' length words first, then their payloads.
  std::vector<uint64_t> loff(n_cols, 0), poff(n_cols, 0);
  uint64_t lens_total = 0, pay_total = 0;
  for (uint64_t c = 0; c < n_cols; c++) {
    if (!ok_out[c]) continue;
    loff[c] = lens_total;
    lens_total += 4ull * ns[c];
    poff[c] = pay_total;
    pay_total += pay[c];
  }
  const uint64_t total = lens_total + pay_total;
  uint8_t* out = (uint8_t*)std::malloc(total ? total : 1);
  if (!out) return -1;
  std::atomic<bool> fail(false);
  run_ranges(n_workers, n_cols, [&](uint64_t c0, uint64_t c1) {
    SegMapCache maps;
    for (uint64_t c = c0; c < c1 && !fail.load(std::memory_order_relaxed);
         c++) {
      if (!ok_out[c] || ns[c] == 0) continue;  // heartbeats carry no bytes
      Wal* w = (Wal*)handles[gs[c] % n_shards];
      const double pack_t0 = mono_s();
      auto git = w->groups.find(gs[c]);
      if (git == w->groups.end()) { fail.store(true); break; }
      auto it = git->second.entries.find(starts[c]);
      uint8_t* lp = out + loff[c];
      uint8_t* pp = out + lens_total + poff[c];
      for (uint32_t k = 0; k < ns[c]; k++, ++it) {
        if (it == git->second.entries.end() ||
            it->first != starts[c] + k) { fail.store(true); break; }
        const EntryRef& r = it->second;
        lp[0] = (uint8_t)r.len; lp[1] = (uint8_t)(r.len >> 8);
        lp[2] = (uint8_t)(r.len >> 16); lp[3] = (uint8_t)(r.len >> 24);
        lp += 4;
        if (!copy_payload(w, gs[c] % n_shards, r, pp, maps)) {
          fail.store(true);
          break;
        }
        pp += r.len;
      }
      w->stat_pack_ns.fetch_add((uint64_t)((mono_s() - pack_t0) * 1e9),
                                std::memory_order_relaxed);
      w->stat_pack_calls.fetch_add(1, std::memory_order_relaxed);
    }
    drop_segmaps(maps);
  });
  if (fail.load()) {
    std::free(out);
    return -1;
  }
  *out_ptr = out;
  return (int64_t)total;
}

void wal_buf_free(uint8_t* p) { std::free(p); }

}  // extern "C"
