// Cross-process shared-memory ring buffer of variable-size blocks: the
// port's own copy of glt_tpu/csrc/shm_queue.cc (the same ring, the same C
// ABI), so glt_tpu_torch loads nothing of the JAX package.
//
// The reference's ShmQueue (graphlearn_torch/csrc/shm_queue.cc,
// include/shm_queue.h:65-122): a SysV shared-memory segment (picklable
// across processes by shmid, the property the reference exploits in
// py_export_glt.cc:138-146) holding a byte ring plus pshared
// mutex/condvars. Blocks are length-prefixed; a reader skips a tail
// fragment too short for a length prefix. Used by
// glt_tpu_torch.channel.ShmChannel to stream serialized sample batches
// from sampling workers to their consumer. Host code: built with g++ into
// glt_tpu_torch/_build/ on first use (glt_tpu_torch/channel/shm.py) and
// loaded through ctypes.
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <pthread.h>
#include <sys/ipc.h>
#include <sys/shm.h>

namespace {

struct QueueHeader {
  uint64_t capacity;      // ring bytes
  uint64_t head;          // read offset  (monotonic)
  uint64_t tail;          // write offset (monotonic)
  uint64_t num_blocks;    // readable blocks
  pthread_mutex_t mutex;
  pthread_cond_t can_read;
  pthread_cond_t can_write;
  uint8_t ring[];         // capacity bytes
};

constexpr uint32_t kWrapMarker = 0xFFFFFFFFu;

inline uint64_t ring_pos(const QueueHeader* q, uint64_t off) {
  return off % q->capacity;
}

inline uint64_t free_bytes(const QueueHeader* q) {
  return q->capacity - (q->tail - q->head);
}

void write_bytes(QueueHeader* q, uint64_t off, const void* src,
                 uint64_t n) {
  uint64_t pos = ring_pos(q, off);
  uint64_t first = (pos + n <= q->capacity) ? n : q->capacity - pos;
  std::memcpy(q->ring + pos, src, first);
  if (n > first) {
    std::memcpy(q->ring, static_cast<const uint8_t*>(src) + first,
                n - first);
  }
}

void read_bytes(const QueueHeader* q, uint64_t off, void* dst,
                uint64_t n) {
  uint64_t pos = ring_pos(q, off);
  uint64_t first = (pos + n <= q->capacity) ? n : q->capacity - pos;
  std::memcpy(dst, q->ring + pos, first);
  if (n > first) {
    std::memcpy(static_cast<uint8_t*>(dst) + first, q->ring, n - first);
  }
}

timespec deadline_after_ms(int timeout_ms) {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += static_cast<long>(timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  return ts;
}

}  // namespace

extern "C" {

// Create a new queue; returns shmid (>=0) or -errno.
int shmq_create(uint64_t capacity) {
  uint64_t total = sizeof(QueueHeader) + capacity;
  int shmid = shmget(IPC_PRIVATE, total, IPC_CREAT | 0600);
  if (shmid < 0) return -errno;
  void* mem = shmat(shmid, nullptr, 0);
  if (mem == reinterpret_cast<void*>(-1)) return -errno;
  auto* q = static_cast<QueueHeader*>(mem);
  q->capacity = capacity;
  q->head = q->tail = 0;
  q->num_blocks = 0;
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&q->mutex, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&q->can_read, &ca);
  pthread_cond_init(&q->can_write, &ca);
  shmdt(mem);
  return shmid;
}

// Attach to an existing queue by shmid; returns pointer handle or null.
void* shmq_attach(int shmid) {
  void* mem = shmat(shmid, nullptr, 0);
  if (mem == reinterpret_cast<void*>(-1)) return nullptr;
  return mem;
}

int shmq_detach(void* handle) {
  return shmdt(handle) == 0 ? 0 : -errno;
}

// Mark for destruction (segment disappears once all detach).
int shmq_destroy(int shmid) {
  return shmctl(shmid, IPC_RMID, nullptr) == 0 ? 0 : -errno;
}

// A holder died mid-update: make the mutex usable again and, if the
// header was left half-written, reset the ring to a sane empty state
// (losing in-flight blocks beats leaving every future op corrupt).
static void recover_dead_owner(QueueHeader* q) {
  pthread_mutex_consistent(&q->mutex);
  // head==tail with nonzero num_blocks catches a consumer killed between
  // advancing head and decrementing num_blocks on the last block; the
  // symmetric head!=tail with zero num_blocks catches a producer killed
  // between advancing tail and incrementing num_blocks on an empty ring.
  if (q->tail - q->head > q->capacity || q->num_blocks > q->capacity ||
      (q->head == q->tail && q->num_blocks != 0) ||
      (q->head != q->tail && q->num_blocks == 0)) {
    q->head = 0;
    q->tail = 0;
    q->num_blocks = 0;
  }
  // The ring state just changed out from under any sleeping waiters
  // (possibly to fully-empty/fully-free); wake them all to re-check.
  pthread_cond_broadcast(&q->can_read);
  pthread_cond_broadcast(&q->can_write);
}

static int lock_robust(QueueHeader* q) {
  int rc = pthread_mutex_lock(&q->mutex);
  if (rc == EOWNERDEAD) {
    recover_dead_owner(q);
    rc = 0;
  }
  return rc;
}

// Timed wait that handles robust-mutex reacquire outcomes: returns 0 to
// re-check the predicate (normal wake, or EOWNERDEAD recovered),
// ETIMEDOUT, or a hard errno the caller must propagate.
static int wait_robust(pthread_cond_t* cv, QueueHeader* q,
                       const timespec* dl) {
  int rc = pthread_cond_timedwait(cv, &q->mutex, dl);
  if (rc == EOWNERDEAD) {
    recover_dead_owner(q);
    return 0;
  }
  return rc;
}

// Blocking enqueue with timeout; returns 0, -ETIMEDOUT, or -EMSGSIZE.
int shmq_enqueue(void* handle, const void* data, uint64_t size,
                 int timeout_ms) {
  auto* q = static_cast<QueueHeader*>(handle);
  uint64_t need = size + sizeof(uint32_t);
  if (need + sizeof(uint32_t) > q->capacity) return -EMSGSIZE;
  timespec dl = deadline_after_ms(timeout_ms);
  if (lock_robust(q) != 0) return -EINVAL;
  for (;;) {
    // wrap handling: if the length prefix itself would straddle the end,
    // emit a wrap marker and start at offset 0 (reference tail-fragment)
    uint64_t pos = ring_pos(q, q->tail);
    uint64_t until_end = q->capacity - pos;
    uint64_t pad = (until_end < sizeof(uint32_t)) ? until_end : 0;
    if (free_bytes(q) >= need + pad) {
      if (pad) {
        // burn the tail fragment
        q->tail += pad;
      }
      uint32_t sz = static_cast<uint32_t>(size);
      write_bytes(q, q->tail, &sz, sizeof(sz));
      write_bytes(q, q->tail + sizeof(sz), data, size);
      q->tail += sizeof(sz) + size;
      q->num_blocks += 1;
      pthread_cond_signal(&q->can_read);
      pthread_mutex_unlock(&q->mutex);
      return 0;
    }
    int rc = wait_robust(&q->can_write, q, &dl);
    if (rc != 0) {
      pthread_mutex_unlock(&q->mutex);
      return -rc;
    }
  }
}

// Size of the next block without consuming it; -ETIMEDOUT on timeout.
int64_t shmq_peek_size(void* handle, int timeout_ms) {
  auto* q = static_cast<QueueHeader*>(handle);
  timespec dl = deadline_after_ms(timeout_ms);
  if (lock_robust(q) != 0) return -EINVAL;
  while (q->num_blocks == 0) {
    int rc = wait_robust(&q->can_read, q, &dl);
    if (rc != 0) {
      pthread_mutex_unlock(&q->mutex);
      return -rc;
    }
  }
  uint64_t head = q->head;
  uint64_t pos = ring_pos(q, head);
  if (q->capacity - pos < sizeof(uint32_t)) {
    head += q->capacity - pos;  // skip tail fragment
  }
  uint32_t sz;
  read_bytes(q, head, &sz, sizeof(sz));
  pthread_mutex_unlock(&q->mutex);
  return static_cast<int64_t>(sz);
}

// Dequeue into out (cap bytes); returns block size, -ETIMEDOUT, or
// -EMSGSIZE if cap is too small (block is left in place).
int64_t shmq_dequeue(void* handle, void* out, uint64_t cap,
                     int timeout_ms) {
  auto* q = static_cast<QueueHeader*>(handle);
  timespec dl = deadline_after_ms(timeout_ms);
  if (lock_robust(q) != 0) return -EINVAL;
  while (q->num_blocks == 0) {
    int rc = wait_robust(&q->can_read, q, &dl);
    if (rc != 0) {
      pthread_mutex_unlock(&q->mutex);
      return -rc;
    }
  }
  uint64_t pos = ring_pos(q, q->head);
  if (q->capacity - pos < sizeof(uint32_t)) {
    q->head += q->capacity - pos;  // skip tail fragment
  }
  uint32_t sz;
  read_bytes(q, q->head, &sz, sizeof(sz));
  if (sz > cap) {
    pthread_mutex_unlock(&q->mutex);
    return -EMSGSIZE;
  }
  read_bytes(q, q->head + sizeof(sz), out, sz);
  q->head += sizeof(sz) + sz;
  q->num_blocks -= 1;
  pthread_cond_signal(&q->can_write);
  pthread_mutex_unlock(&q->mutex);
  return static_cast<int64_t>(sz);
}

uint64_t shmq_size(void* handle) {
  auto* q = static_cast<QueueHeader*>(handle);
  lock_robust(q);
  uint64_t n = q->num_blocks;
  pthread_mutex_unlock(&q->mutex);
  return n;
}

int shmq_empty(void* handle) {
  return shmq_size(handle) == 0 ? 1 : 0;
}

}  // extern "C"
