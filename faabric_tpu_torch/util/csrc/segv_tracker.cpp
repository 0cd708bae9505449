// SIGSEGV write-fault dirty tracker — the reference's headline precision
// mode re-built for this runtime (reference src/util/dirty.cpp segfault
// tracker, include/faabric/util/dirty.h:12-17): mprotect the tracked
// image PROT_READ; the FIRST write to each page faults into this
// handler, which records the page in a caller-owned flags byte-array and
// restores PROT_READ|PROT_WRITE for that page only. Cost model:
//   start  = one mprotect over the range (O(VMA splits), no data touched)
//   write  = one fault per DIRTY page, ~2-4 us, then full speed
//   stop   = one mprotect restore
//   query  = read the flags array
// i.e. O(dirty) — no baseline copy, no O(image) scan per bracket.
//
// The handler must be async-signal-safe: it only reads the fixed region
// table, writes one byte, and calls mprotect (not POSIX-listed but
// kernel-atomic and used for exactly this by every fault-tracking
// runtime). Faults outside every tracked region chain to the previously
// installed handler (faulthandler / libtpu install their own).
//
// Region table: fixed slots claimed by CAS so segv_start/segv_stop from
// multiple threads never lock against the handler (a handler cannot
// take locks). active transitions 0 -> 2 (claiming, invisible to the
// handler) -> 1 (live) -> 0.

#include <atomic>
#include <csignal>
#include <cstdint>
#include <cstring>
#include <sys/mman.h>
#include <unistd.h>

namespace {

constexpr int MAX_REGIONS = 128;
constexpr uintptr_t PAGE = 4096;

struct Region {
    std::atomic<int> active{0};
    uintptr_t start = 0;  // page-aligned
    uint64_t n_pages = 0;
    uint8_t* flags = nullptr;  // one byte per page, caller-owned
};

Region g_regions[MAX_REGIONS];
struct sigaction g_prev;
std::atomic<int> g_installed{0};

void handler(int sig, siginfo_t* info, void* ctx)
{
    uintptr_t addr = reinterpret_cast<uintptr_t>(info->si_addr);
    for (int i = 0; i < MAX_REGIONS; i++) {
        Region& r = g_regions[i];
        if (r.active.load(std::memory_order_acquire) != 1) {
            continue;
        }
        if (addr < r.start || addr >= r.start + r.n_pages * PAGE) {
            continue;
        }
        uint64_t page = (addr - r.start) / PAGE;
        r.flags[page] = 1;
        mprotect(reinterpret_cast<void*>(r.start + page * PAGE),
                 PAGE,
                 PROT_READ | PROT_WRITE);
        return;
    }
    // Not a tracked fault: chain to whoever was installed before us
    if ((g_prev.sa_flags & SA_SIGINFO) && g_prev.sa_sigaction != nullptr) {
        g_prev.sa_sigaction(sig, info, ctx);
        return;
    }
    if (g_prev.sa_handler == SIG_IGN) {
        return;
    }
    if (g_prev.sa_handler != SIG_DFL && g_prev.sa_handler != nullptr) {
        g_prev.sa_handler(sig);
        return;
    }
    // Default disposition: re-deliver fatally so crashes stay crashes
    signal(SIGSEGV, SIG_DFL);
    raise(SIGSEGV);
}

}  // namespace

extern "C" {

// Install the process-wide handler (idempotent). 0 on success.
int segv_install()
{
    int expected = 0;
    if (!g_installed.compare_exchange_strong(expected, 1)) {
        return 0;
    }
    struct sigaction sa;
    memset(&sa, 0, sizeof(sa));
    sa.sa_sigaction = handler;
    sa.sa_flags = SA_SIGINFO;
    sigemptyset(&sa.sa_mask);
    if (sigaction(SIGSEGV, &sa, &g_prev) != 0) {
        g_installed.store(0);
        return -1;
    }
    return 0;
}

// Write-protect [start, start + n_pages*4096) and route its faults into
// `flags` (uint8 per page, caller-owned, zeroed by caller). `start` must
// be page-aligned. Returns a region id >= 0, or <0 on error.
int segv_start(void* start, uint64_t n_pages, void* flags)
{
    uintptr_t s = reinterpret_cast<uintptr_t>(start);
    if (s % PAGE != 0 || n_pages == 0) {
        return -1;
    }
    for (int i = 0; i < MAX_REGIONS; i++) {
        Region& r = g_regions[i];
        int expected = 0;
        if (!r.active.compare_exchange_strong(expected, 2)) {
            continue;
        }
        r.start = s;
        r.n_pages = n_pages;
        r.flags = static_cast<uint8_t*>(flags);
        // Publish the region BEFORE mprotect: no fault can occur until the
        // protection takes effect, and any write racing with the mprotect
        // must already find a live region or the handler would chain the
        // fault to the default handler and crash the process.
        r.active.store(1, std::memory_order_release);
        if (mprotect(start, n_pages * PAGE, PROT_READ) != 0) {
            r.active.store(0, std::memory_order_release);
            return -2;
        }
        return i;
    }
    return -3;  // region table full
}

// Restore write access and retire the region. 0 on success.
int segv_stop(int id)
{
    if (id < 0 || id >= MAX_REGIONS) {
        return -1;
    }
    Region& r = g_regions[id];
    if (r.active.load(std::memory_order_acquire) != 1) {
        return -1;
    }
    mprotect(reinterpret_cast<void*>(r.start),
             r.n_pages * PAGE,
             PROT_READ | PROT_WRITE);
    r.active.store(0, std::memory_order_release);
    return 0;
}

}  // extern "C"
