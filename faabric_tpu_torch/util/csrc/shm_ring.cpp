// Lock-free single-producer/single-consumer byte ring over a shared
// mapping — the same-machine data plane under transport/shm.py.
//
// Reference analog: faabric's in-memory MPI queues (atomic_queue /
// moodycamel SPSC, include/faabric/mpi/MpiWorld.h:29-33) carry same-host
// rank traffic without touching sockets. There ranks are threads of one
// process; here co-located ranks live in separate worker PROCESSES, so
// the queue lives in a /dev/shm mapping and the indices are C++ atomics
// on shared cache lines (Python cannot express cross-process atomics —
// this is why the hot path is native).
//
// Layout (192-byte header, then capacity bytes of data):
//   [0]   u64 magic
//   [8]   u64 capacity (power of two)
//   [64]  atomic u64 head — bytes ever written (producer-owned)
//   [72]  atomic u32 data_seq — bumped per push (futex word, consumer waits)
//   [128] atomic u64 tail — bytes ever read (consumer-owned)
//   [136] atomic u32 space_seq — bumped per pop (futex word, producer waits)
// Head and tail sit on their own cache lines: the producer writes head
// and reads tail, the consumer the reverse; sharing a line would bounce
// it between cores on every frame. Each side's futex word shares ITS
// writer's line.
//
// Frames: u64 payload length, then payload bytes, modular over the data
// region. A frame is visible to the consumer only once the head store
// (release) publishes it whole; partial writes can never be read.
//
// Blocking: waiters use shared futexes on the seq words with BOUNDED
// timeouts (the seq-vs-head visibility order is not total, so a wait
// could theoretically park just after missing its wakeup — the timeout
// turns that race into at worst one bounded stall, never a hang).
// Pushers futex-wake after every publish, poppers after every free —
// one ~µs syscall per frame is noise next to the ≥256 KiB memcpys the
// bulk plane moves, and it is what lets the other PROCESS block in the
// kernel instead of burning a core polling (the cross-process analog of
// the reference's in-process condition-variable queues, util/queue.h).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t MAGIC = 0xFAAB51A6C0FFEE02ULL;
constexpr uint64_t HDR_BYTES = 192;

struct RingHdr {
    uint64_t magic;
    uint64_t capacity;
    char pad0[48];
    std::atomic<uint64_t> head;
    std::atomic<uint32_t> data_seq;
    char pad1[52];
    std::atomic<uint64_t> tail;
    std::atomic<uint32_t> space_seq;
    char pad2[52];
};

int futex_wait(std::atomic<uint32_t>* addr, uint32_t expected,
               uint32_t timeout_us) {
    struct timespec ts;
    ts.tv_sec = timeout_us / 1000000;
    ts.tv_nsec = (timeout_us % 1000000) * 1000L;
    // No FUTEX_PRIVATE_FLAG: the mapping is shared across processes
    return syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAIT,
                   expected, &ts, nullptr, 0);
}

void futex_wake(std::atomic<uint32_t>* addr) {
    syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE, 1,
            nullptr, nullptr, 0);
}

static_assert(sizeof(RingHdr) == HDR_BYTES, "header layout is the ABI");
static_assert(sizeof(std::atomic<uint64_t>) == 8,
              "atomic u64 must be plain u64 in shared memory");

inline RingHdr* hdr(void* base) { return static_cast<RingHdr*>(base); }

inline char* data(void* base) {
    return static_cast<char*>(base) + HDR_BYTES;
}

// Copy into the ring at logical position pos (modular), handling wrap.
inline void put(void* base, uint64_t cap, uint64_t pos, const void* src,
                uint64_t len) {
    uint64_t off = pos & (cap - 1);
    uint64_t first = cap - off < len ? cap - off : len;
    std::memcpy(data(base) + off, src, first);
    if (len > first) {
        std::memcpy(data(base), static_cast<const char*>(src) + first,
                    len - first);
    }
}

inline void get(void* base, uint64_t cap, uint64_t pos, void* dst,
                uint64_t len) {
    uint64_t off = pos & (cap - 1);
    uint64_t first = cap - off < len ? cap - off : len;
    std::memcpy(dst, data(base) + off, first);
    if (len > first) {
        std::memcpy(static_cast<char*>(dst) + first, data(base), len - first);
    }
}

}  // namespace

extern "C" {

// capacity must be a power of two; the mapping must be HDR_BYTES +
// capacity long and zeroed. Returns 0 on success.
int ring_init(void* base, uint64_t capacity) {
    if (capacity == 0 || (capacity & (capacity - 1)) != 0) return -1;
    RingHdr* h = new (base) RingHdr;
    h->capacity = capacity;
    h->head.store(0, std::memory_order_relaxed);
    h->tail.store(0, std::memory_order_relaxed);
    h->data_seq.store(0, std::memory_order_relaxed);
    h->space_seq.store(0, std::memory_order_relaxed);
    // Magic last: an attacher seeing it may trust the rest
    std::atomic_thread_fence(std::memory_order_release);
    h->magic = MAGIC;
    return 0;
}

// Validates an existing mapping before attach. Returns capacity, or -1.
int64_t ring_check(void* base) {
    RingHdr* h = hdr(base);
    if (h->magic != MAGIC) return -1;
    uint64_t cap = h->capacity;
    if (cap == 0 || (cap & (cap - 1)) != 0) return -1;
    return static_cast<int64_t>(cap);
}

int64_t ring_free_space(void* base) {
    RingHdr* h = hdr(base);
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    return static_cast<int64_t>(h->capacity - (head - tail));
}

// Push one frame gathered from nsegs segments. Returns 0 on success,
// -1 if there is not enough free space (caller retries/falls back),
// -2 if the frame can never fit this ring.
int ring_try_pushv(void* base, const void* const* segs,
                   const uint64_t* lens, uint64_t nsegs) {
    RingHdr* h = hdr(base);
    uint64_t cap = h->capacity;
    uint64_t total = 0;
    for (uint64_t i = 0; i < nsegs; i++) total += lens[i];
    uint64_t need = total + 8;
    if (need > cap) return -2;
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    if (need > cap - (head - tail)) return -1;
    put(base, cap, head, &total, 8);
    uint64_t pos = head + 8;
    for (uint64_t i = 0; i < nsegs; i++) {
        put(base, cap, pos, segs[i], lens[i]);
        pos += lens[i];
    }
    h->head.store(head + need, std::memory_order_release);
    h->data_seq.fetch_add(1, std::memory_order_release);
    futex_wake(&h->data_seq);
    return 0;
}

// Length of the next frame's payload without consuming it; -1 if empty.
int64_t ring_peek(void* base) {
    RingHdr* h = hdr(base);
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    if (head == tail) return -1;
    uint64_t len;
    get(base, h->capacity, tail, &len, 8);
    return static_cast<int64_t>(len);
}

// Pop the next frame into out (maxlen bytes). Returns the payload
// length, -1 if empty, -2 if out is too small (frame not consumed).
int64_t ring_pop(void* base, void* out, uint64_t maxlen) {
    RingHdr* h = hdr(base);
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    if (head == tail) return -1;
    uint64_t len;
    get(base, h->capacity, tail, &len, 8);
    if (len > maxlen) return -2;
    get(base, h->capacity, tail + 8, out, len);
    h->tail.store(tail + 8 + len, std::memory_order_release);
    h->space_seq.fetch_add(1, std::memory_order_release);
    futex_wake(&h->space_seq);
    return static_cast<int64_t>(len);
}

// Pop up to max_frames consecutive frames into out (out_len bytes),
// recording each frame's payload length in lens. Stops before a frame
// that would overflow out (a batch consumer falls back to ring_pop for
// oversized frames). The tail advances ONCE for the whole batch — one
// space-futex wake per batch instead of per frame, which is what makes
// draining a burst of small frames cheap. Returns the frame count
// (0 when empty or the next frame alone exceeds out_len).
int64_t ring_pop_batch(void* base, void* out, uint64_t out_len,
                       uint64_t* lens, uint64_t max_frames) {
    RingHdr* h = hdr(base);
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    uint64_t cap = h->capacity;
    uint64_t produced = 0;
    uint64_t written = 0;
    while (produced < max_frames && head != tail) {
        uint64_t len;
        get(base, cap, tail, &len, 8);
        if (written + len > out_len) break;
        get(base, cap, tail + 8, static_cast<char*>(out) + written, len);
        written += len;
        tail += 8 + len;
        lens[produced++] = len;
    }
    if (produced) {
        h->tail.store(tail, std::memory_order_release);
        h->space_seq.fetch_add(1, std::memory_order_release);
        futex_wake(&h->space_seq);
    }
    return static_cast<int64_t>(produced);
}

// Block (in the kernel) until a frame is likely available or timeout_us
// elapsed. Returns 0 when data is visible, 1 on timeout/spurious wake —
// callers loop around try_pop either way.
int ring_wait_data(void* base, uint32_t timeout_us) {
    RingHdr* h = hdr(base);
    uint32_t seq = h->data_seq.load(std::memory_order_acquire);
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    if (h->head.load(std::memory_order_acquire) != tail) return 0;
    futex_wait(&h->data_seq, seq, timeout_us);
    return h->head.load(std::memory_order_acquire) != tail ? 0 : 1;
}

// Block until >= need bytes of frame space are likely free, or timeout.
int ring_wait_space(void* base, uint64_t need, uint32_t timeout_us) {
    RingHdr* h = hdr(base);
    uint32_t seq = h->space_seq.load(std::memory_order_acquire);
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t cap = h->capacity;
    if (cap - (head - h->tail.load(std::memory_order_acquire)) >= need)
        return 0;
    futex_wait(&h->space_seq, seq, timeout_us);
    return (cap - (head - h->tail.load(std::memory_order_acquire)) >= need)
               ? 0 : 1;
}

}  // extern "C"
