// Host shared-memory object store ("plasma" tier) of ray_tpu_torch: the
// port's own copy of ``ray_tpu/native/src/plasma.cc``.
//
// Equivalent of the reference's per-node plasma store
// (ref: src/ray/object_manager/plasma/store.h:55,
//       object_lifecycle_manager.h, eviction_policy.h, dlmalloc.cc): every
// process on the host (the driver and its process-tier workers) maps ONE
// shared arena file and talks to the store through lock-protected shared
// state *inside the arena itself*, instead of the reference's unix-socket +
// fd-passing protocol (plasma/fling.cc).  There is no store server process:
// the store is a library.
//
// Layout of the arena file (mmap'd MAP_SHARED by every client):
//
//   [ Header | ObjectEntry table (open addressing) | heap ............ ]
//
// * Header holds a PTHREAD_PROCESS_SHARED + ROBUST mutex and a futex word,
//   ``seal_seq``: the robust attribute keeps the store usable when a worker
//   process dies while holding the lock, and getters wait on the futex word
//   instead of a process-shared condvar.  A condvar is not robust: glibc's
//   keeps per-waiter state inside it, so a process killed while it waits
//   (a worker's resident loop blocked in get() when its pool terminates it)
//   leaves every later broadcast blocked forever, and with it every seal.
//   A futex wait leaves nothing behind.
// * Allocation is a boundary-tag first-fit heap with coalescing.
// * Eviction is LRU over sealed, unreferenced objects and runs inline inside
//   create() when the heap is full; the caller spills to disk when create
//   still fails after eviction.
//
// Object lifecycle: CREATED (writable by creator) -> SEALED (immutable,
// readable by all; get() blocks on the futex word until seal) -> deleted when
// refcount hits zero and delete/evict is requested.  tps_unseal re-opens a
// sealed object for in-place mutation.
//
// Unlike the copy in ray_tpu, a client can be interrupted: tps_interrupt
// marks the handle closing and wakes every getter blocked in get(), which
// then returns -4 instead of waiting on.  The Python client calls it
// before it waits for its calls in flight and frees the handle, so a get
// blocked on one thread never runs on a handle another thread has freed.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <linux/futex.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x54505553544f5245ULL;  // "TPUSTORE"
constexpr uint32_t kVersion = 3;  // 3: futex word in place of the condvar
constexpr uint32_t kIdLen = 20;
constexpr uint32_t kBlockMagic = 0xb10cb10c;
constexpr uint64_t kAlign = 64;  // cacheline; also keeps numpy views aligned

// ---------------------------------------------------------------- shm layout

struct ObjectEntry {
  uint8_t id[kIdLen];
  uint8_t state;   // 0 empty, 1 created, 2 sealed, 3 tombstone
  uint8_t in_lru;  // member of the evictable LRU list
  uint32_t refcount;
  uint64_t offset;  // data offset from arena base
  uint64_t size;
  uint64_t lru_tick;
  uint32_t lru_next;  // entry index + 1; 0 = none
  uint32_t lru_prev;
};

enum EntryState : uint8_t { kEmpty = 0, kCreated = 1, kSealed = 2, kTomb = 3 };

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t max_entries;
  uint64_t capacity;     // total file size
  uint64_t heap_offset;  // from base
  uint64_t heap_size;
  uint64_t bytes_in_use;  // payload bytes of live objects
  uint64_t num_objects;
  uint64_t lru_clock;
  uint64_t free_head;  // offset of first free block, 0 = none
  uint32_t lru_head;   // evictable (sealed, refcount==0) entries, LRU first;
  uint32_t lru_tail;   // entry index + 1, 0 = none
  pthread_mutex_t mutex;
  // Bumped (under the mutex) by every seal and interrupt; getters wait for
  // it to change.  Padded to the condvar it replaces, so the table and the
  // heap sit where ray_tpu's arena puts them.
  uint32_t seal_seq;
  uint8_t pad[sizeof(pthread_cond_t) - sizeof(uint32_t)];
};

// Boundary tag kept immediately before each payload; free blocks embed the
// free-list links in their (unused) payload.
struct BlockHeader {
  uint64_t size;       // payload bytes (excludes header)
  uint64_t prev_size;  // payload size of the block physically before us
  uint32_t magic;
  uint32_t free;
};

struct FreeLinks {  // lives at payload[0] of free blocks
  uint64_t next;    // arena offsets of BlockHeaders; 0 = end
  uint64_t prev;
};

struct Client {
  uint8_t* base;
  Header* hdr;
  ObjectEntry* table;
  uint64_t mapped_size;
  int fd;
  int owner;
  // Set by tps_interrupt (this process only): blocked getters give up.
  volatile int closing;
};

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

inline BlockHeader* block_at(Client* c, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(c->base + off);
}
inline uint64_t payload_off(uint64_t block_off) { return block_off + sizeof(BlockHeader); }
inline FreeLinks* links_of(Client* c, uint64_t block_off) {
  return reinterpret_cast<FreeLinks*>(c->base + payload_off(block_off));
}

// ------------------------------------------------------------------- locking

// Robust lock: if a worker died holding the mutex, adopt and repair it.
int lock(Client* c) {
  int rc = pthread_mutex_lock(&c->hdr->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&c->hdr->mutex);
    rc = 0;
  }
  return rc;
}
void unlock(Client* c) { pthread_mutex_unlock(&c->hdr->mutex); }

// Caller holds the lock: bump the sequence and wake every waiter, in any
// process (a shared futex: no FUTEX_PRIVATE_FLAG).
void wake_getters(Client* c) {
  __atomic_add_fetch(&c->hdr->seal_seq, 1, __ATOMIC_RELEASE);
  syscall(SYS_futex, &c->hdr->seal_seq, FUTEX_WAKE, INT32_MAX, nullptr,
          nullptr, 0);
}

// Wait until seal_seq differs from `seen` or `rel` elapses (null: no
// bound); spurious returns are fine, callers re-check.
void wait_seq(Client* c, uint32_t seen, const struct timespec* rel) {
  syscall(SYS_futex, &c->hdr->seal_seq, FUTEX_WAIT, seen, rel, nullptr, 0);
}

// ----------------------------------------------------------------- allocator

void freelist_push(Client* c, uint64_t block_off) {
  BlockHeader* b = block_at(c, block_off);
  b->free = 1;
  FreeLinks* l = links_of(c, block_off);
  l->next = c->hdr->free_head;
  l->prev = 0;
  if (c->hdr->free_head) links_of(c, c->hdr->free_head)->prev = block_off;
  c->hdr->free_head = block_off;
}

void freelist_remove(Client* c, uint64_t block_off) {
  FreeLinks* l = links_of(c, block_off);
  if (l->prev)
    links_of(c, l->prev)->next = l->next;
  else
    c->hdr->free_head = l->next;
  if (l->next) links_of(c, l->next)->prev = l->prev;
  block_at(c, block_off)->free = 0;
}

uint64_t next_block_off(Client* c, uint64_t block_off) {
  BlockHeader* b = block_at(c, block_off);
  uint64_t n = block_off + sizeof(BlockHeader) + b->size;
  uint64_t end = c->hdr->heap_offset + c->hdr->heap_size;
  return (n + sizeof(BlockHeader) <= end) ? n : 0;
}

uint64_t prev_block_off(Client* c, uint64_t block_off) {
  BlockHeader* b = block_at(c, block_off);
  if (b->prev_size == 0 && block_off == c->hdr->heap_offset) return 0;
  uint64_t p = block_off - sizeof(BlockHeader) - b->prev_size;
  return (p >= c->hdr->heap_offset) ? p : 0;
}

// First-fit allocate `want` payload bytes; returns block offset or 0.
uint64_t heap_alloc(Client* c, uint64_t want) {
  want = align_up(want < sizeof(FreeLinks) ? sizeof(FreeLinks) : want, kAlign);
  uint64_t off = c->hdr->free_head;
  while (off) {
    BlockHeader* b = block_at(c, off);
    if (b->size >= want) {
      freelist_remove(c, off);
      uint64_t leftover = b->size - want;
      if (leftover >= sizeof(BlockHeader) + align_up(sizeof(FreeLinks), kAlign)) {
        // split: carve the tail into a new free block
        b->size = want;
        uint64_t tail_off = off + sizeof(BlockHeader) + want;
        BlockHeader* tail = block_at(c, tail_off);
        tail->size = leftover - sizeof(BlockHeader);
        tail->prev_size = want;
        tail->magic = kBlockMagic;
        freelist_push(c, tail_off);
        uint64_t after = next_block_off(c, tail_off);
        if (after) block_at(c, after)->prev_size = tail->size;
      }
      return off;
    }
    off = links_of(c, off)->next;
  }
  return 0;
}

void heap_free(Client* c, uint64_t block_off) {
  BlockHeader* b = block_at(c, block_off);
  // coalesce forward
  uint64_t n = next_block_off(c, block_off);
  if (n && block_at(c, n)->free) {
    freelist_remove(c, n);
    b->size += sizeof(BlockHeader) + block_at(c, n)->size;
  }
  // coalesce backward
  uint64_t p = prev_block_off(c, block_off);
  if (p && block_at(c, p)->free) {
    freelist_remove(c, p);
    block_at(c, p)->size += sizeof(BlockHeader) + b->size;
    block_off = p;
    b = block_at(c, block_off);
  }
  freelist_push(c, block_off);
  uint64_t after = next_block_off(c, block_off);
  if (after) block_at(c, after)->prev_size = b->size;
}

// ------------------------------------------------------------------ LRU list
// Intrusive doubly-linked list of evictable entries (sealed, refcount==0),
// head = least recent (ref: plasma/eviction_policy.h).  O(1) maintenance on
// seal/get/release beats a full table scan per eviction victim.

inline ObjectEntry* entry_at(Client* c, uint32_t idx1) {
  return idx1 ? &c->table[idx1 - 1] : nullptr;
}

void lru_push_mru(Client* c, ObjectEntry* e) {
  if (e->in_lru) return;
  e->in_lru = 1;
  uint32_t me = (uint32_t)(e - c->table) + 1;
  e->lru_prev = c->hdr->lru_tail;
  e->lru_next = 0;
  if (c->hdr->lru_tail) entry_at(c, c->hdr->lru_tail)->lru_next = me;
  c->hdr->lru_tail = me;
  if (!c->hdr->lru_head) c->hdr->lru_head = me;
}

void lru_remove(Client* c, ObjectEntry* e) {
  if (!e->in_lru) return;
  e->in_lru = 0;
  if (e->lru_prev) entry_at(c, e->lru_prev)->lru_next = e->lru_next;
  else c->hdr->lru_head = e->lru_next;
  if (e->lru_next) entry_at(c, e->lru_next)->lru_prev = e->lru_prev;
  else c->hdr->lru_tail = e->lru_prev;
  e->lru_next = e->lru_prev = 0;
}

// -------------------------------------------------------------- object table

uint64_t id_hash(const uint8_t* id) {
  // FNV-1a over the 20-byte id
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; ++i) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// Find entry for id; if absent and want_insert, claim a slot. Returns null if
// the table is full or the id is absent (and !want_insert).
ObjectEntry* table_find(Client* c, const uint8_t* id, bool want_insert) {
  uint32_t n = c->hdr->max_entries;
  uint64_t h = id_hash(id) % n;
  ObjectEntry* first_tomb = nullptr;
  for (uint32_t probe = 0; probe < n; ++probe) {
    ObjectEntry* e = &c->table[(h + probe) % n];
    if (e->state == kEmpty) {
      if (!want_insert) return nullptr;
      ObjectEntry* slot = first_tomb ? first_tomb : e;
      std::memcpy(slot->id, id, kIdLen);
      return slot;
    }
    if (e->state == kTomb) {
      if (!first_tomb) first_tomb = e;
      continue;
    }
    if (std::memcmp(e->id, id, kIdLen) == 0) return e;
  }
  if (want_insert && first_tomb) {
    std::memcpy(first_tomb->id, id, kIdLen);
    return first_tomb;
  }
  return nullptr;
}

void entry_delete(Client* c, ObjectEntry* e) {
  lru_remove(c, e);
  heap_free(c, e->offset - sizeof(BlockHeader));
  c->hdr->bytes_in_use -= e->size;
  c->hdr->num_objects -= 1;
  e->state = kTomb;
  e->refcount = 0;
  e->offset = e->size = 0;
}

// Evict LRU sealed refcount==0 objects until >= want bytes of payload are
// freed (ref: plasma/eviction_policy.h LRU). Caller holds lock.
uint64_t evict_locked(Client* c, uint64_t want) {
  uint64_t freed = 0;
  while (freed < want && c->hdr->lru_head) {
    ObjectEntry* victim = entry_at(c, c->hdr->lru_head);
    freed += victim->size;
    entry_delete(c, victim);  // removes from the list
  }
  return freed;
}

}  // namespace

extern "C" {

// Create or attach the arena at `path`. `create`!=0 initializes a fresh
// store of `capacity` bytes (total file size). Returns handle or null.
void* tps_connect(const char* path, uint64_t capacity, uint32_t max_entries,
                  int create) {
  int fd = open(path, create ? (O_RDWR | O_CREAT) : O_RDWR, 0600);
  if (fd < 0) return nullptr;

  if (create) {
    if (ftruncate(fd, (off_t)capacity) != 0) {
      close(fd);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(Header)) {
      close(fd);
      return nullptr;
    }
    capacity = (uint64_t)st.st_size;
  }

  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }

  Client* c = new Client();
  c->base = (uint8_t*)base;
  c->hdr = (Header*)base;
  c->mapped_size = capacity;
  c->fd = fd;
  c->owner = create;
  c->closing = 0;

  if (create) {
    if (max_entries == 0) max_entries = 1 << 16;
    Header* h = c->hdr;
    std::memset(h, 0, sizeof(Header));
    h->magic = kMagic;
    h->version = kVersion;
    h->max_entries = max_entries;
    h->capacity = capacity;
    uint64_t table_off = align_up(sizeof(Header), kAlign);
    uint64_t table_bytes = (uint64_t)max_entries * sizeof(ObjectEntry);
    h->heap_offset = align_up(table_off + table_bytes, kAlign);
    if (h->heap_offset + sizeof(BlockHeader) + kAlign > capacity) {
      munmap(base, capacity);
      close(fd);
      delete c;
      return nullptr;
    }
    h->heap_size = capacity - h->heap_offset;
    c->table = (ObjectEntry*)(c->base + table_off);
    std::memset(c->table, 0, table_bytes);

    pthread_mutexattr_t ma;
    pthread_mutexattr_init(&ma);
    pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mutex, &ma);
    h->seal_seq = 0;

    // one big free block spanning the heap
    BlockHeader* b = block_at(c, h->heap_offset);
    b->size = h->heap_size - sizeof(BlockHeader);
    b->prev_size = 0;
    b->magic = kBlockMagic;
    h->free_head = 0;
    freelist_push(c, h->heap_offset);
  } else {
    if (c->hdr->magic != kMagic || c->hdr->version != kVersion) {
      munmap(base, capacity);
      close(fd);
      delete c;
      return nullptr;
    }
    uint64_t table_off = align_up(sizeof(Header), kAlign);
    c->table = (ObjectEntry*)(c->base + table_off);
  }
  return c;
}

// Mark the handle closing and wake every getter blocked in get(); each of
// this handle's getters then returns -4.  Getters of other handles wake,
// find nothing new and wait again.  The flag is set before the sequence is
// bumped, so a getter either sees it before it waits or is woken by the
// bump.
void tps_interrupt(void* h) {
  Client* c = (Client*)h;
  if (!c) return;
  __atomic_store_n(&c->closing, 1, __ATOMIC_RELEASE);
  lock(c);
  wake_getters(c);
  unlock(c);
}

void tps_disconnect(void* h, int unlink_file, const char* path) {
  Client* c = (Client*)h;
  if (!c) return;
  munmap(c->base, c->mapped_size);
  close(c->fd);
  if (unlink_file && path) unlink(path);
  delete c;
}

// Create a writable object of `size` payload bytes. On success returns 0 and
// sets *out_off (arena offset of payload). -1 id exists, -2 out of memory
// (even after eviction), -3 table full.
int tps_create(void* h, const uint8_t* id, uint64_t size, uint64_t* out_off) {
  Client* c = (Client*)h;
  lock(c);
  ObjectEntry* existing = table_find(c, id, false);
  if (existing && existing->state != kTomb) {
    unlock(c);
    return -1;
  }
  uint64_t block = heap_alloc(c, size);
  if (!block) {
    evict_locked(c, size + sizeof(BlockHeader));
    block = heap_alloc(c, size);
  }
  if (!block) {
    unlock(c);
    return -2;
  }
  ObjectEntry* e = table_find(c, id, true);
  if (!e) {
    heap_free(c, block);
    unlock(c);
    return -3;
  }
  e->state = kCreated;
  e->in_lru = 0;
  e->lru_next = e->lru_prev = 0;
  e->refcount = 1;  // creator's reference
  e->offset = payload_off(block);
  e->size = size;
  e->lru_tick = ++c->hdr->lru_clock;
  c->hdr->bytes_in_use += size;
  c->hdr->num_objects += 1;
  *out_off = e->offset;
  unlock(c);
  return 0;
}

// Seal: object becomes immutable + visible to get(). Wakes blocked getters.
int tps_seal(void* h, const uint8_t* id) {
  Client* c = (Client*)h;
  lock(c);
  ObjectEntry* e = table_find(c, id, false);
  if (!e || e->state != kCreated) {
    unlock(c);
    return -1;
  }
  e->state = kSealed;
  if (e->refcount == 0) lru_push_mru(c, e);
  wake_getters(c);
  unlock(c);
  return 0;
}

// Re-open a sealed object for in-place mutation (compiled-graph channels,
// ref: experimental_mutable_object_manager.h). Requires sole ownership
// (refcount of the caller's reference only).
int tps_unseal(void* h, const uint8_t* id) {
  Client* c = (Client*)h;
  lock(c);
  ObjectEntry* e = table_find(c, id, false);
  if (!e || e->state != kSealed) {
    unlock(c);
    return -1;
  }
  if (e->refcount != 1) {  // enforce sole ownership: no readers' live views
    unlock(c);
    return -2;
  }
  e->state = kCreated;
  unlock(c);
  return 0;
}

// Blocking get: waits until sealed (timeout_ms < 0 = forever, 0 = poll).
// On success refcount++ and returns 0 with payload offset/size.
// -1 = not found & not created yet and timeout hit (or poll miss);
// -4 = the handle was interrupted (tps_interrupt) while waiting.
int tps_get(void* h, const uint8_t* id, int64_t timeout_ms, uint64_t* out_off,
            uint64_t* out_size) {
  Client* c = (Client*)h;
  struct timespec deadline;
  if (timeout_ms > 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += timeout_ms / 1000;
    deadline.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (deadline.tv_nsec >= 1000000000L) {
      deadline.tv_sec += 1;
      deadline.tv_nsec -= 1000000000L;
    }
  }
  lock(c);
  for (;;) {
    ObjectEntry* e = table_find(c, id, false);
    if (e && e->state == kSealed) {
      if (e->refcount == 0) lru_remove(c, e);  // no longer evictable
      e->refcount += 1;
      e->lru_tick = ++c->hdr->lru_clock;
      *out_off = e->offset;
      *out_size = e->size;
      unlock(c);
      return 0;
    }
    if (timeout_ms == 0) {
      unlock(c);
      return -1;
    }
    if (__atomic_load_n(&c->closing, __ATOMIC_ACQUIRE)) {
      unlock(c);
      return -4;
    }
    // Read under the lock: a seal after this read bumps it, so the wait
    // below returns at once instead of missing the wakeup.
    uint32_t seen = __atomic_load_n(&c->hdr->seal_seq, __ATOMIC_ACQUIRE);
    unlock(c);
    if (timeout_ms > 0) {
      struct timespec now, rel;
      clock_gettime(CLOCK_MONOTONIC, &now);
      rel.tv_sec = deadline.tv_sec - now.tv_sec;
      rel.tv_nsec = deadline.tv_nsec - now.tv_nsec;
      if (rel.tv_nsec < 0) {
        rel.tv_sec -= 1;
        rel.tv_nsec += 1000000000L;
      }
      if (rel.tv_sec < 0) return -1;
      wait_seq(c, seen, &rel);
    } else {
      wait_seq(c, seen, nullptr);
    }
    lock(c);
  }
}

int tps_release(void* h, const uint8_t* id) {
  Client* c = (Client*)h;
  lock(c);
  ObjectEntry* e = table_find(c, id, false);
  if (!e || e->state == kTomb || e->state == kEmpty) {
    unlock(c);
    return -1;
  }
  if (e->refcount > 0) {
    e->refcount -= 1;
    if (e->refcount == 0 && e->state == kSealed) lru_push_mru(c, e);
  }
  unlock(c);
  return 0;
}

// Delete now if unreferenced; sealed+referenced objects are deleted lazily by
// eviction once released (ref: object_lifecycle_manager.h eager deletion).
int tps_delete(void* h, const uint8_t* id) {
  Client* c = (Client*)h;
  lock(c);
  ObjectEntry* e = table_find(c, id, false);
  if (!e || e->state == kTomb || e->state == kEmpty) {
    unlock(c);
    return -1;
  }
  if (e->refcount > 0) {
    unlock(c);
    return -2;
  }
  entry_delete(c, e);
  unlock(c);
  return 0;
}

int tps_contains(void* h, const uint8_t* id) {
  Client* c = (Client*)h;
  lock(c);
  ObjectEntry* e = table_find(c, id, false);
  int r = (e && e->state == kSealed) ? 1 : 0;
  unlock(c);
  return r;
}

uint64_t tps_evict(void* h, uint64_t nbytes) {
  Client* c = (Client*)h;
  lock(c);
  uint64_t freed = evict_locked(c, nbytes);
  unlock(c);
  return freed;
}

void tps_usage(void* h, uint64_t* used, uint64_t* capacity, uint64_t* objects) {
  Client* c = (Client*)h;
  lock(c);
  *used = c->hdr->bytes_in_use;
  *capacity = c->hdr->heap_size;
  *objects = c->hdr->num_objects;
  unlock(c);
}

// Refcount of an object, or -1 if absent. Test/introspection hook.
int64_t tps_refcount(void* h, const uint8_t* id) {
  Client* c = (Client*)h;
  lock(c);
  ObjectEntry* e = table_find(c, id, false);
  int64_t r = (e && e->state != kTomb && e->state != kEmpty) ? (int64_t)e->refcount : -1;
  unlock(c);
  return r;
}

}  // extern "C"
