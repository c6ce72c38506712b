// shm_ring.cpp — native SPSC shared-memory window ring for ddl_tpu_torch.
//
// The port's own copy of ddl_tpu/transport/csrc/shm_ring.cpp: the same
// segment layout, seqcount protocol and ddlr_* C interface, so a ring made
// by either package opens in the other.  The one addition is
// ddlr_map_base / ddlr_map_bytes (the whole mapping), which the consumer
// page-locks with cudaHostRegister so a window's copy to the card is a DMA
// straight out of the slot.
//
// A replacement for the reference's MPI-3 RMA shared-memory windows
// and token protocol (reference ddl/connection.py:88-182): the reference got
// cross-process window handoff from MPI's native core (Win.Allocate_shared +
// Lock_all + Ssend tokens); here the same semantics are implemented directly
// on POSIX shm + C11/C++ atomics:
//
//   * one shm segment per (producer, consumer) pair
//   * `committed` / `released` monotonic counters with release/acquire
//     ordering play the role of the zero-byte tag-7 token messages
//     (connection.py:153-182) — a slot's data is fully written before the
//     counter store that publishes it is visible (the property MPI gave via
//     synchronous-mode sends, connection.py:157-159)
//   * a `shutdown` flag observed inside every wait loop replaces the
//     cancellable Waitany-vs-Ibarrier race (connection.py:161-182, §3.5)
//   * waits are bounded (timeout) and account their stall time, feeding the
//     input-pipeline-stall% north-star metric (BASELINE.md)
//
// Exposed as a plain C ABI consumed via ctypes
// (ddl_tpu_torch/transport/shm_ring.py).

#include <atomic>
#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#ifdef __linux__
#include <linux/futex.h>
#include <sys/syscall.h>
#endif

namespace {

constexpr uint64_t kMagic = 0xDD17B0F5A11C0DE5ULL;
constexpr uint32_t kVersion = 2;  // v2: doorbell word in the header
constexpr size_t kCacheLine = 64;

struct alignas(kCacheLine) Header {
  uint64_t magic;
  uint32_t version;
  uint32_t nslots;
  uint64_t slot_bytes;
  uint64_t data_offset;  // byte offset of slot 0 payload from segment base
  // Producer- and consumer-owned counters on separate cache lines to avoid
  // false sharing in the spin loops.
  alignas(kCacheLine) std::atomic<uint64_t> committed;
  alignas(kCacheLine) std::atomic<uint64_t> released;
  alignas(kCacheLine) std::atomic<uint32_t> shutdown;
  // Futex doorbell: every publishable event (commit, release, shutdown)
  // increments it and wakes its waiters.  Waiters snapshot it BEFORE
  // evaluating their predicate and park with that snapshot as `expect`,
  // so an event landing between predicate check and park flips the word
  // and FUTEX_WAIT returns EAGAIN — the condition-variable pattern with
  // no lost-wake window, covering shutdown too (a flag store alone
  // could land after a waiter's check but before it parks).
  alignas(kCacheLine) std::atomic<uint32_t> doorbell;
  // Stall counters on their own line: they are fetch_add'ed from both
  // processes once per wait and must not bounce the hot doorbell line.
  alignas(kCacheLine) std::atomic<uint64_t> prod_stall_us;
  std::atomic<uint64_t> cons_stall_us;
  // Variable-length: per-slot committed payload sizes, then slot payloads.
  // payload_bytes[i] is written by the producer before the `committed`
  // release-store that publishes slot i, so the consumer's acquire-load
  // ordering covers it too.
  alignas(kCacheLine) uint64_t payload_bytes[1];
};

inline size_t header_bytes(uint32_t nslots) {
  size_t h = offsetof(Header, payload_bytes) + nslots * sizeof(uint64_t);
  return (h + kCacheLine - 1) / kCacheLine * kCacheLine;
}

inline uint64_t now_us() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000ull + ts.tv_nsec / 1000;
}

// Event-driven waits via the header doorbell (replaces the original
// 1ms-capped usleep ladder, which woke every idle producer ~1000x/s —
// each wake preempting the consumer on 1-core hosts).  NOT
// FUTEX_PRIVATE: waiter and waker are different processes sharing the
// mapping.
#ifdef __linux__
inline void futex_wait_on(std::atomic<uint32_t>* word, uint32_t expect,
                          int64_t timeout_us) {
  struct timespec ts;
  ts.tv_sec = timeout_us / 1000000;
  ts.tv_nsec = (timeout_us % 1000000) * 1000;
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAIT, expect,
          &ts, nullptr, 0);
}

inline void futex_wake_all(std::atomic<uint32_t>* word) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAKE,
          INT32_MAX, nullptr, nullptr, 0);
}
#else
// Non-Linux POSIX: no cross-process futex — fall back to the bounded
// usleep ladder (1ms cap, the pre-doorbell behavior).  The caller's
// loop re-checks the predicate after every nap, so correctness is
// unchanged; only idle-wakeup cost regresses to ~1000/s.
inline void futex_wait_on(std::atomic<uint32_t>* word, uint32_t expect,
                          int64_t timeout_us) {
  if (word->load(std::memory_order_acquire) != expect) return;
  if (timeout_us > 1000 || timeout_us < 0) timeout_us = 1000;
  usleep(static_cast<useconds_t>(timeout_us));
}

inline void futex_wake_all(std::atomic<uint32_t>*) {}
#endif

}  // namespace

struct ddlr_ring {
  Header* hdr;
  size_t map_bytes;
  int owner;  // created (vs opened) — owner unlinks
  char name[256];
};

extern "C" {

ddlr_ring* ddlr_create(const char* name, uint32_t nslots, uint64_t slot_bytes) {
  if (nslots < 1 || slot_bytes == 0) return nullptr;
  // Tolerate a stale segment from a crashed prior run.
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t hbytes = header_bytes(nslots);
  size_t total = hbytes + static_cast<size_t>(nslots) * slot_bytes;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Header* h = static_cast<Header*>(base);
  std::memset(base, 0, hbytes);
  h->version = kVersion;
  h->nslots = nslots;
  h->slot_bytes = slot_bytes;
  h->data_offset = hbytes;
  h->committed.store(0, std::memory_order_relaxed);
  h->released.store(0, std::memory_order_relaxed);
  h->shutdown.store(0, std::memory_order_relaxed);
  // Publish the header last: openers spin on magic until init is complete.
  std::atomic_thread_fence(std::memory_order_release);
  h->magic = kMagic;

  ddlr_ring* r = new ddlr_ring();
  r->hdr = h;
  r->map_bytes = total;
  r->owner = 1;
  std::snprintf(r->name, sizeof(r->name), "%s", name);
  return r;
}

ddlr_ring* ddlr_open(const char* name) {
  int fd = -1;
  // The peer may not have created the segment yet — retry briefly.
  for (int i = 0; i < 2000; ++i) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd >= 0) break;
    usleep(1000);
  }
  if (fd < 0) return nullptr;
  struct stat st;
  // Wait until the creator has ftruncated + written the header.
  for (int i = 0; i < 2000; ++i) {
    if (fstat(fd, &st) == 0 && st.st_size > static_cast<off_t>(sizeof(Header)))
      break;
    usleep(1000);
  }
  size_t total = static_cast<size_t>(st.st_size);
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(base);
  for (int i = 0; i < 2000 && h->magic != kMagic; ++i) usleep(1000);
  if (h->magic != kMagic || h->version != kVersion) {
    munmap(base, total);
    return nullptr;
  }
  ddlr_ring* r = new ddlr_ring();
  r->hdr = h;
  r->map_bytes = total;
  r->owner = 0;
  std::snprintf(r->name, sizeof(r->name), "%s", name);
  return r;
}

// Wait until pred (expressed via counters) holds. Returns slot index >= 0,
// -1 on timeout, -2 on shutdown. Ladder: brief pause-spin (the peer may
// be mid-commit on another core), one sched_yield round (single-CPU
// hosts — the peer literally needs our timeslice), then an event-driven
// futex sleep on the doorbell.  The doorbell snapshot is taken BEFORE
// the predicate loads, so any event (commit/release/shutdown) landing
// after the check flips the word and the park returns immediately —
// no lost-wake window for any of the three events.  Futex chunks are
// capped at 100ms as pure paranoia (the protocol needs no polling); in
// the normal path the peer's wake lands in microseconds and idle
// waiters cost ZERO periodic wakeups — the property that matters when
// producers and consumer share one core (docs/PERF_NOTES.md).
static int wait_slot(ddlr_ring* r, bool producer, int64_t timeout_us,
                     uint32_t ahead = 0) {
  Header* h = r->hdr;
  uint64_t start = now_us();
  int spins = 0;
  for (;;) {
    uint32_t bell = h->doorbell.load(std::memory_order_acquire);
    if (h->shutdown.load(std::memory_order_acquire)) return -2;
    uint64_t committed = h->committed.load(std::memory_order_acquire);
    uint64_t released = h->released.load(std::memory_order_acquire);
    if (producer) {
      if (committed - released < h->nslots)
        return static_cast<int>(committed % h->nslots);
    } else {
      // ahead > 0: the consumer still holds `ahead` drained-but-unreleased
      // slots and wants the next committed one after those — the lookahead
      // primitive behind double-buffered window streaming.
      if (committed > released + ahead)
        return static_cast<int>((released + ahead) % h->nslots);
    }
    uint64_t waited = now_us() - start;
    if (timeout_us >= 0 && waited > static_cast<uint64_t>(timeout_us)) {
      return -1;
    }
    ++spins;
    if (spins < 64) {
#if defined(__x86_64__)
      __builtin_ia32_pause();
#endif
    } else if (spins < 96) {
      sched_yield();
    } else {
      int64_t chunk = 100000;  // pure lost-wake paranoia, not polling
      if (timeout_us >= 0) {
        int64_t left = timeout_us - static_cast<int64_t>(waited);
        if (left < chunk) chunk = left > 0 ? left : 1;
      }
      futex_wait_on(&h->doorbell, bell, chunk);
    }
  }
}

// Ring an event: memory effects of the event must be published (their
// release-stores) BEFORE this increment, whose own release-store orders
// it after them; parked waiters wake and re-evaluate.
static void ring_doorbell(Header* h) {
  h->doorbell.fetch_add(1, std::memory_order_release);
  futex_wake_all(&h->doorbell);
}

static void add_stall(std::atomic<uint64_t>& ctr, uint64_t t0) {
  uint64_t dt = now_us() - t0;
  if (dt) ctr.fetch_add(dt, std::memory_order_relaxed);
}

int ddlr_acquire_fill(ddlr_ring* r, int64_t timeout_us) {
  uint64_t t0 = now_us();
  int s = wait_slot(r, /*producer=*/true, timeout_us);
  add_stall(r->hdr->prod_stall_us, t0);
  return s;
}

void ddlr_commit(ddlr_ring* r, uint32_t slot, uint64_t payload_bytes) {
  Header* h = r->hdr;
  h->payload_bytes[slot] = payload_bytes;
  // Release-store publishes the payload and payload_bytes together.
  h->committed.store(h->committed.load(std::memory_order_relaxed) + 1,
                     std::memory_order_release);
  ring_doorbell(h);
}

int ddlr_acquire_drain(ddlr_ring* r, int64_t timeout_us) {
  uint64_t t0 = now_us();
  int s = wait_slot(r, /*producer=*/false, timeout_us);
  add_stall(r->hdr->cons_stall_us, t0);
  return s;
}

// Acquire the (ahead+1)-th oldest committed slot while the consumer still
// holds `ahead` unreleased ones. Returns -3 when ahead >= nslots (the ring
// cannot hold that many outstanding drains). Release order stays FIFO.
int ddlr_acquire_drain_ahead(ddlr_ring* r, uint32_t ahead, int64_t timeout_us) {
  if (ahead >= r->hdr->nslots) return -3;
  uint64_t t0 = now_us();
  int s = wait_slot(r, /*producer=*/false, timeout_us, ahead);
  add_stall(r->hdr->cons_stall_us, t0);
  return s;
}

void ddlr_release(ddlr_ring* r, uint32_t slot) {
  (void)slot;
  Header* h = r->hdr;
  h->released.store(h->released.load(std::memory_order_relaxed) + 1,
                    std::memory_order_release);
  ring_doorbell(h);
}

uint8_t* ddlr_slot_ptr(ddlr_ring* r, uint32_t slot) {
  Header* h = r->hdr;
  return reinterpret_cast<uint8_t*>(h) + h->data_offset +
         static_cast<size_t>(slot) * h->slot_bytes;
}

uint64_t ddlr_slot_payload(ddlr_ring* r, uint32_t slot) {
  return r->hdr->payload_bytes[slot];
}

void ddlr_shutdown(ddlr_ring* r) {
  r->hdr->shutdown.store(1, std::memory_order_release);
  // The doorbell snapshot/park protocol makes this wake reliable even
  // against a waiter preempted between its flag check and its park.
  ring_doorbell(r->hdr);
}

int ddlr_is_shutdown(ddlr_ring* r) {
  return static_cast<int>(r->hdr->shutdown.load(std::memory_order_acquire));
}

uint64_t ddlr_stat(ddlr_ring* r, int which) {
  Header* h = r->hdr;
  switch (which) {
    case 0: return h->prod_stall_us.load(std::memory_order_relaxed);
    case 1: return h->cons_stall_us.load(std::memory_order_relaxed);
    case 2: return h->committed.load(std::memory_order_relaxed);
    case 3: return h->released.load(std::memory_order_relaxed);
    default: return 0;
  }
}

uint32_t ddlr_nslots(ddlr_ring* r) { return r->hdr->nslots; }
uint64_t ddlr_slot_bytes(ddlr_ring* r) { return r->hdr->slot_bytes; }

// The whole mapping (header + slots): its page-aligned base and length.
void* ddlr_map_base(ddlr_ring* r) { return r->hdr; }
uint64_t ddlr_map_bytes(ddlr_ring* r) { return r->map_bytes; }

void ddlr_close(ddlr_ring* r) {
  if (!r) return;
  munmap(r->hdr, r->map_bytes);
  delete r;
}

void ddlr_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
