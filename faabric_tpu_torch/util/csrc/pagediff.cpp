// Native helpers for the snapshot/dirty-tracking hot path.
//
// Reference analog: the byte-granular diff loops in
// src/util/snapshot.cpp (diffWithDirtyRegions) and the XOR delta in
// src/util/delta.cpp — there C++ over mprotect'd guest memory; here C++
// over executor/host buffers, exposed to Python via ctypes (no pybind11
// in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC pagediff.cpp -o libpagediff.so

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Compare old/new buffers page-by-page; flags[i] = 1 where page i differs.
// Returns the number of dirty pages.
size_t diff_pages(const uint8_t* oldBuf, const uint8_t* newBuf, size_t len,
                  size_t pageSize, uint8_t* flags) {
    size_t nPages = (len + pageSize - 1) / pageSize;
    size_t nDirty = 0;
    for (size_t i = 0; i < nPages; i++) {
        size_t off = i * pageSize;
        size_t chunk = (off + pageSize <= len) ? pageSize : (len - off);
        uint8_t dirty = std::memcmp(oldBuf + off, newBuf + off, chunk) != 0;
        flags[i] = dirty;
        nDirty += dirty;
    }
    return nDirty;
}

// Within one page, find the changed byte ranges at `granularity`-sized
// chunks (reference compares at 128B chunks, snapshot.h:18-21). Writes up
// to maxRanges (start, length) pairs; returns the count.
size_t diff_ranges(const uint8_t* oldBuf, const uint8_t* newBuf, size_t len,
                   size_t granularity, size_t* starts, size_t* lengths,
                   size_t maxRanges) {
    size_t n = 0;
    size_t i = 0;
    while (i < len && n < maxRanges) {
        size_t chunk = (i + granularity <= len) ? granularity : (len - i);
        if (std::memcmp(oldBuf + i, newBuf + i, chunk) != 0) {
            size_t start = i;
            size_t end = i + chunk;
            i += chunk;
            // extend while consecutive chunks differ
            while (i < len) {
                size_t c2 = (i + granularity <= len) ? granularity : (len - i);
                if (std::memcmp(oldBuf + i, newBuf + i, c2) == 0) break;
                end = i + c2;
                i += c2;
            }
            starts[n] = start;
            lengths[n] = end - start;
            n++;
        } else {
            i += chunk;
        }
    }
    return n;
}

// out = a XOR b (delta encoding primitive)
void xor_buffers(const uint8_t* a, const uint8_t* b, uint8_t* out,
                 size_t len) {
    for (size_t i = 0; i < len; i++) {
        out[i] = a[i] ^ b[i];
    }
}

}  // extern "C"
