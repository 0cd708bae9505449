// userfaultfd write-protect dirty tracker — the reference's
// "uffd-thread-wp" mode re-built for this runtime (reference
// src/util/dirty.cpp uffd impls, include/faabric/util/dirty.h:124-192,
// include/faabric/util/userfaultfd.h): the tracked range is registered
// with UFFDIO_REGISTER_MODE_WP and armed with UFFDIO_WRITEPROTECT; the
// FIRST write to each page parks the writer on a kernel queue and wakes
// a dedicated event thread, which records the page in a caller-owned
// flags array and clears write protection for that page (which also
// wakes the writer). Cost model is the same O(dirty) as the SIGSEGV
// tracker, with two differences the reference chose it for:
//   - faults are delivered as ordinary file events to ONE thread — no
//     process-wide signal handler, no async-signal-safety constraints,
//     no interaction with other SIGSEGV users (libtpu, faulthandler);
//   - kernel-side writes into the range (read(2), recv into the
//     buffer) fault-and-resolve normally instead of failing EFAULT.
// Requires CONFIG_USERFAULTFD + uffd-wp (kernel >= 5.7) on anonymous
// memory; uffd_install() reports absence and the Python ladder falls
// back (uffd -> segv -> native).
//
// Region table: fixed slots claimed under g_mu by uffd_start/uffd_stop;
// the event thread reads it under the same mutex (unlike a signal
// handler, it MAY take locks — that is the point of this mode).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <linux/userfaultfd.h>
#include <mutex>
#include <poll.h>
#include <sys/ioctl.h>
#include <sys/syscall.h>
#include <thread>
#include <unistd.h>

// Newer kernel feature than this image's headers: write-protect marker
// PTEs for not-yet-populated anonymous pages (kernel >= 6.4). Without
// it the WRITEPROTECT ioctl only marks EXISTING PTEs, and writes to
// untouched pages of a fresh allocation never fault.
#ifndef UFFD_FEATURE_WP_UNPOPULATED
#define UFFD_FEATURE_WP_UNPOPULATED (1 << 13)
#endif

namespace {

constexpr int MAX_REGIONS = 128;
constexpr uintptr_t PAGE = 4096;
bool g_wp_unpopulated = false;

struct Region {
    bool active = false;
    uintptr_t start = 0;  // page-aligned
    uint64_t n_pages = 0;
    uint8_t* flags = nullptr;  // one byte per page, caller-owned
};

int g_fd = -1;
Region g_regions[MAX_REGIONS];
std::mutex g_mu;
// Heap-allocated so no global std::thread destructor can std::terminate
// the process at exit while the event loop is still parked in poll()
std::thread* g_thread = nullptr;
std::atomic<bool> g_stop{false};
int g_wake_pipe[2] = {-1, -1};

void write_unprotect(uintptr_t addr, uint64_t len)
{
    struct uffdio_writeprotect wp;
    wp.range.start = addr;
    wp.range.len = len;
    wp.mode = 0;  // clear WP; waking the parked writer is the default
    ioctl(g_fd, UFFDIO_WRITEPROTECT, &wp);
}

void event_loop()
{
    struct pollfd fds[2];
    fds[0] = {g_fd, POLLIN, 0};
    fds[1] = {g_wake_pipe[0], POLLIN, 0};
    while (!g_stop.load(std::memory_order_acquire)) {
        if (poll(fds, 2, 1000) <= 0) {
            continue;
        }
        if (fds[1].revents & POLLIN) {
            char c;
            (void)!read(g_wake_pipe[0], &c, 1);
            continue;  // re-check g_stop
        }
        struct uffd_msg msg;
        ssize_t n = read(g_fd, &msg, sizeof(msg));
        if (n != static_cast<ssize_t>(sizeof(msg))) {
            continue;
        }
        if (msg.event != UFFD_EVENT_PAGEFAULT) {
            continue;
        }
        uintptr_t addr = msg.arg.pagefault.address & ~(PAGE - 1);
        {
            std::lock_guard<std::mutex> lock(g_mu);
            for (int i = 0; i < MAX_REGIONS; i++) {
                Region& r = g_regions[i];
                if (!r.active || addr < r.start ||
                    addr >= r.start + r.n_pages * PAGE) {
                    continue;
                }
                r.flags[(addr - r.start) / PAGE] = 1;
                break;
            }
        }
        // Always resolve (even for a just-retired region) or the
        // faulting thread would park forever
        write_unprotect(addr, PAGE);
    }
}

}  // namespace

extern "C" {

// Open the userfaultfd, negotiate WP support and start the event
// thread (idempotent). 0 on success, <0 when the kernel lacks
// userfaultfd or write-protect mode.
int uffd_install()
{
    std::lock_guard<std::mutex> lock(g_mu);
    if (g_fd >= 0) {
        return 0;
    }
    int fd = static_cast<int>(
      syscall(SYS_userfaultfd, O_CLOEXEC | O_NONBLOCK));
    if (fd < 0) {
        return -1;
    }
    struct uffdio_api api;
    memset(&api, 0, sizeof(api));
    api.api = UFFD_API;
    api.features =
      UFFD_FEATURE_PAGEFAULT_FLAG_WP | UFFD_FEATURE_WP_UNPOPULATED;
    if (ioctl(fd, UFFDIO_API, &api) != 0) {
        // Retry without the newer feature (kernel < 6.4): handled by
        // pre-faulting pages in uffd_start instead
        close(fd);
        fd = static_cast<int>(
          syscall(SYS_userfaultfd, O_CLOEXEC | O_NONBLOCK));
        if (fd < 0) {
            return -1;
        }
        memset(&api, 0, sizeof(api));
        api.api = UFFD_API;
        api.features = UFFD_FEATURE_PAGEFAULT_FLAG_WP;
        if (ioctl(fd, UFFDIO_API, &api) != 0) {
            close(fd);
            return -2;
        }
    }
    if (!(api.features & UFFD_FEATURE_PAGEFAULT_FLAG_WP)) {
        close(fd);
        return -2;
    }
    g_wp_unpopulated = (api.features & UFFD_FEATURE_WP_UNPOPULATED) != 0;
    if (pipe(g_wake_pipe) != 0) {
        close(fd);
        return -3;
    }
    g_fd = fd;
    g_stop.store(false);
    g_thread = new std::thread(event_loop);
    return 0;
}

// Register + write-protect [start, start + n_pages*4096); faults route
// into `flags` (uint8 per page, caller-owned, zeroed by caller).
// `start` must be page-aligned. Returns a region id >= 0, or <0.
int uffd_start(void* start, uint64_t n_pages, void* flags)
{
    uintptr_t s = reinterpret_cast<uintptr_t>(start);
    if (g_fd < 0 || s % PAGE != 0 || n_pages == 0) {
        return -1;
    }
    struct uffdio_register reg;
    memset(&reg, 0, sizeof(reg));
    reg.range.start = s;
    reg.range.len = n_pages * PAGE;
    reg.mode = UFFDIO_REGISTER_MODE_WP;
    if (ioctl(g_fd, UFFDIO_REGISTER, &reg) != 0) {
        return -2;
    }
    if (!g_wp_unpopulated) {
        // Pre-6.4 kernels only write-protect EXISTING PTEs: touch every
        // page with a read so the zero page is mapped before arming
        volatile uint8_t sink = 0;
        for (uint64_t p = 0; p < n_pages; p++) {
            sink += *reinterpret_cast<volatile uint8_t*>(s + p * PAGE);
        }
        (void)sink;
    }
    // Claim and publish the region BEFORE arming write protection
    // (mirroring segv_start): once the WRITEPROTECT ioctl lands, a
    // concurrent writer can fault immediately, and the event thread
    // must find a live region or it resolves the fault without
    // recording the dirty bit — a silently lost page.
    int id = -1;
    {
        std::lock_guard<std::mutex> lock(g_mu);
        for (int i = 0; i < MAX_REGIONS; i++) {
            Region& r = g_regions[i];
            if (r.active) {
                continue;
            }
            r.start = s;
            r.n_pages = n_pages;
            r.flags = static_cast<uint8_t*>(flags);
            r.active = true;
            id = i;
            break;
        }
    }
    if (id < 0) {
        struct uffdio_range rng = {s, n_pages * PAGE};
        ioctl(g_fd, UFFDIO_UNREGISTER, &rng);
        return -4;  // region table full
    }
    struct uffdio_writeprotect wp;
    wp.range.start = s;
    wp.range.len = n_pages * PAGE;
    wp.mode = UFFDIO_WRITEPROTECT_MODE_WP;
    if (ioctl(g_fd, UFFDIO_WRITEPROTECT, &wp) != 0) {
        {
            std::lock_guard<std::mutex> lock(g_mu);
            g_regions[id].active = false;
        }
        struct uffdio_range rng = {s, n_pages * PAGE};
        ioctl(g_fd, UFFDIO_UNREGISTER, &rng);
        return -3;
    }
    return id;
}

// Clear write protection, unregister and retire the region. 0 on
// success.
int uffd_stop(int id)
{
    if (id < 0 || id >= MAX_REGIONS) {
        return -1;
    }
    uintptr_t s;
    uint64_t len;
    {
        std::lock_guard<std::mutex> lock(g_mu);
        Region& r = g_regions[id];
        if (!r.active) {
            return -1;
        }
        s = r.start;
        len = r.n_pages * PAGE;
        r.active = false;
    }
    write_unprotect(s, len);
    struct uffdio_range rng = {s, len};
    ioctl(g_fd, UFFDIO_UNREGISTER, &rng);
    return 0;
}

// Stop the event thread and close the fd (process teardown only).
void uffd_shutdown()
{
    {
        std::lock_guard<std::mutex> lock(g_mu);
        if (g_fd < 0) {
            return;
        }
    }
    g_stop.store(true, std::memory_order_release);
    (void)!write(g_wake_pipe[1], "x", 1);
    if (g_thread != nullptr && g_thread->joinable()) {
        g_thread->join();
    }
    delete g_thread;
    g_thread = nullptr;
    std::lock_guard<std::mutex> lock(g_mu);
    close(g_fd);
    g_fd = -1;
    close(g_wake_pipe[0]);
    close(g_wake_pipe[1]);
    g_wake_pipe[0] = g_wake_pipe[1] = -1;
}

}  // extern "C"
