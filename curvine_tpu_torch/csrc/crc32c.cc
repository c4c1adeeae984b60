// CRC32C (Castagnoli) for the port's media checksums, host C++.
//
// The port's own copy of cv_crc32c from the JAX package's helper library
// (csrc/native.cc, lines 20-220): the slice-by-8 table walk, and where
// the CPU has SSE4.2 the crc32 instruction over three interleaved lanes
// stitched together with a GF(2) "append N zero bytes" operator. Built
// by gpu/_build.py with the host C++ compiler into the package's build/
// directory; worker/blockfile.py loads it with ctypes. cv_crc32c_init
// fills every table once, before the first call, so that concurrent
// callers (ctypes drops the GIL) only ever read them.

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------
// slice-by-8 tables, polynomial 0x1EDC6F41 (reflected 0x82F63B78)
// ---------------------------------------------------------------------

static uint32_t crc32c_table[8][256];

static void crc32c_table_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ ((crc & 1) ? 0x82F63B78u : 0);
        crc32c_table[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = crc32c_table[0][i];
        for (int k = 1; k < 8; k++) {
            crc = crc32c_table[0][crc & 0xFF] ^ (crc >> 8);
            crc32c_table[k][i] = crc;
        }
    }
}

static int crc32c_have_sse42 = 0;

#if defined(__x86_64__) || defined(__i386__)
// SSE4.2 path: the x86 crc32 instruction computes exactly this
// polynomial an order of magnitude faster than the table walk — it is
// what lets end-to-end read verification stay inside its perf budget.
// The instruction has 3-cycle latency / 1-cycle throughput, so a single
// dependency chain tops out near 8 B/3 cycles; three interleaved lanes
// stitched back together with a GF(2) "advance by N zero bytes"
// operator run at close to the 8 B/cycle throughput limit.

static uint32_t gf2_times(const uint32_t* mat, uint32_t vec) {
    uint32_t sum = 0;
    while (vec) {
        if (vec & 1) sum ^= *mat;
        vec >>= 1;
        mat++;
    }
    return sum;
}

static void gf2_square(uint32_t* dst, const uint32_t* src) {
    for (int n = 0; n < 32; n++) dst[n] = gf2_times(src, src[n]);
}

// operator matrix for appending `len` zero bytes to a crc32c
static void crc32c_zeros_op(uint32_t* even, size_t len) {
    uint32_t odd[32];
    odd[0] = 0x82F63B78u;          // one zero bit
    uint32_t row = 1;
    for (int n = 1; n < 32; n++) {
        odd[n] = row;
        row <<= 1;
    }
    gf2_square(even, odd);         // two zero bits
    gf2_square(odd, even);         // four zero bits
    do {                           // 8, 16, ... zero bits
        gf2_square(even, odd);
        len >>= 1;
        if (len == 0) return;
        gf2_square(odd, even);
        len >>= 1;
    } while (len);
    for (int n = 0; n < 32; n++) even[n] = odd[n];
}

// bake the operator into byte-indexed tables for a 4-lookup shift
static void crc32c_zeros(uint32_t zeros[4][256], size_t len) {
    uint32_t op[32];
    crc32c_zeros_op(op, len);
    for (uint32_t n = 0; n < 256; n++) {
        zeros[0][n] = gf2_times(op, n);
        zeros[1][n] = gf2_times(op, n << 8);
        zeros[2][n] = gf2_times(op, n << 16);
        zeros[3][n] = gf2_times(op, n << 24);
    }
}

static inline uint32_t crc32c_shift(const uint32_t zeros[4][256],
                                    uint32_t crc) {
    return zeros[0][crc & 0xFF] ^ zeros[1][(crc >> 8) & 0xFF] ^
           zeros[2][(crc >> 16) & 0xFF] ^ zeros[3][crc >> 24];
}

#define CRC_LANE_LONG 8192
#define CRC_LANE_SHORT 256
static uint32_t crc32c_shift_long[4][256];
static uint32_t crc32c_shift_short[4][256];

__attribute__((target("sse4.2")))
static uint32_t crc32c_sse42(const uint8_t* data, size_t len,
                             uint32_t crc) {
    while (len && (reinterpret_cast<uintptr_t>(data) & 7)) {
        crc = __builtin_ia32_crc32qi(crc, *data++);
        len--;
    }
    while (len >= 3 * CRC_LANE_LONG) {
        uint64_t c0 = crc, c1 = 0, c2 = 0;
        const uint8_t* end = data + CRC_LANE_LONG;
        do {
            uint64_t w0, w1, w2;
            memcpy(&w0, data, 8);
            memcpy(&w1, data + CRC_LANE_LONG, 8);
            memcpy(&w2, data + 2 * CRC_LANE_LONG, 8);
            c0 = __builtin_ia32_crc32di(c0, w0);
            c1 = __builtin_ia32_crc32di(c1, w1);
            c2 = __builtin_ia32_crc32di(c2, w2);
            data += 8;
        } while (data < end);
        crc = crc32c_shift(crc32c_shift_long,
                           static_cast<uint32_t>(c0)) ^
              static_cast<uint32_t>(c1);
        crc = crc32c_shift(crc32c_shift_long, crc) ^
              static_cast<uint32_t>(c2);
        data += 2 * CRC_LANE_LONG;
        len -= 3 * CRC_LANE_LONG;
    }
    while (len >= 3 * CRC_LANE_SHORT) {
        uint64_t c0 = crc, c1 = 0, c2 = 0;
        const uint8_t* end = data + CRC_LANE_SHORT;
        do {
            uint64_t w0, w1, w2;
            memcpy(&w0, data, 8);
            memcpy(&w1, data + CRC_LANE_SHORT, 8);
            memcpy(&w2, data + 2 * CRC_LANE_SHORT, 8);
            c0 = __builtin_ia32_crc32di(c0, w0);
            c1 = __builtin_ia32_crc32di(c1, w1);
            c2 = __builtin_ia32_crc32di(c2, w2);
            data += 8;
        } while (data < end);
        crc = crc32c_shift(crc32c_shift_short,
                           static_cast<uint32_t>(c0)) ^
              static_cast<uint32_t>(c1);
        crc = crc32c_shift(crc32c_shift_short, crc) ^
              static_cast<uint32_t>(c2);
        data += 2 * CRC_LANE_SHORT;
        len -= 3 * CRC_LANE_SHORT;
    }
    uint64_t c = crc;
    while (len >= 8) {
        uint64_t word;
        memcpy(&word, data, 8);
        c = __builtin_ia32_crc32di(c, word);
        data += 8;
        len -= 8;
    }
    crc = static_cast<uint32_t>(c);
    while (len--) {
        crc = __builtin_ia32_crc32qi(crc, *data++);
    }
    return crc;
}

#endif

// Fill the tables and probe the CPU. Call once before cv_crc32c.
void cv_crc32c_init() {
    crc32c_table_init();
#if defined(__x86_64__) || defined(__i386__)
    crc32c_have_sse42 = __builtin_cpu_supports("sse4.2") ? 1 : 0;
    if (crc32c_have_sse42) {
        crc32c_zeros(crc32c_shift_long, CRC_LANE_LONG);
        crc32c_zeros(crc32c_shift_short, CRC_LANE_SHORT);
    }
#endif
}

// The SSE4.2 path, 1 when the CPU has it (for tests and reports).
int cv_crc32c_hw() { return crc32c_have_sse42; }

// crc32c of len bytes at data, chained from seed (0 to start).
uint32_t cv_crc32c(const uint8_t* data, size_t len, uint32_t seed) {
    uint32_t crc = ~seed;
#if defined(__x86_64__) || defined(__i386__)
    if (crc32c_have_sse42) return ~crc32c_sse42(data, len, crc);
#endif
    // align to 8 bytes
    while (len && (reinterpret_cast<uintptr_t>(data) & 7)) {
        crc = crc32c_table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
        len--;
    }
    while (len >= 8) {
        uint64_t word;
        memcpy(&word, data, 8);
        word ^= crc;
        crc = crc32c_table[7][word & 0xFF] ^
              crc32c_table[6][(word >> 8) & 0xFF] ^
              crc32c_table[5][(word >> 16) & 0xFF] ^
              crc32c_table[4][(word >> 24) & 0xFF] ^
              crc32c_table[3][(word >> 32) & 0xFF] ^
              crc32c_table[2][(word >> 40) & 0xFF] ^
              crc32c_table[1][(word >> 48) & 0xFF] ^
              crc32c_table[0][(word >> 56) & 0xFF];
        data += 8;
        len -= 8;
    }
    while (len--) {
        crc = crc32c_table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    }
    return ~crc;
}

}  // extern "C"
