// GF(256) multiply-accumulate for the port's Reed-Solomon codec, host C++.
//
// The port's own copy of cv_gf_mul_xor from the JAX package's helper
// library (csrc/native.cc, lines 224-300): dst[i] ^= gf_mul(coef, src[i])
// over the field polynomial 0x11d. The product table is filled by
// shift-and-add; where the CPU has SSSE3 each byte is split into nibbles
// and both halves are resolved with one pshufb each (GF(2) linearity:
// mul(c, hi << 4 | lo) = mul(c, hi << 4) ^ mul(c, lo)), 16 bytes an
// iteration. Built by gpu/_build.py with the host C++ compiler into the
// package's build/ directory; common/ec.py loads it with ctypes.
// cv_gf_init fills the table once, before the first call, so that
// concurrent callers (ctypes drops the GIL) only ever read it.

#include <cstdint>
#include <cstddef>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif

extern "C" {

static uint8_t gf_mul_slow(uint8_t a, uint8_t b) {
    uint8_t p = 0;
    while (b) {
        if (b & 1) p ^= a;
        b >>= 1;
        a = (uint8_t)((a << 1) ^ ((a & 0x80) ? 0x1d : 0));
    }
    return p;
}

static uint8_t gf_mul_table[256][256];
static int gf_have_ssse3 = 0;

void cv_gf_init() {
    for (unsigned a = 0; a < 256; a++)
        for (unsigned b = 0; b < 256; b++)
            gf_mul_table[a][b] = gf_mul_slow((uint8_t)a, (uint8_t)b);
#if defined(__x86_64__) || defined(__i386__)
    gf_have_ssse3 = __builtin_cpu_supports("ssse3") ? 1 : 0;
#endif
}

// 1 where the pshufb loop serves, 0 for the table walk
int cv_gf_hw() { return gf_have_ssse3; }

#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("ssse3")))
static void gf_mul_xor_ssse3(uint8_t* dst, const uint8_t* src, size_t len,
                             const uint8_t* row) {
    uint8_t lo[16], hi[16];
    for (int j = 0; j < 16; j++) {
        lo[j] = row[j];
        hi[j] = row[j << 4];
    }
    const __m128i lo_tbl = _mm_loadu_si128((const __m128i*)lo);
    const __m128i hi_tbl = _mm_loadu_si128((const __m128i*)hi);
    const __m128i mask = _mm_set1_epi8(0x0f);
    size_t i = 0;
    for (; i + 16 <= len; i += 16) {
        __m128i v = _mm_loadu_si128((const __m128i*)(src + i));
        __m128i l = _mm_shuffle_epi8(lo_tbl, _mm_and_si128(v, mask));
        __m128i h = _mm_shuffle_epi8(
            hi_tbl, _mm_and_si128(_mm_srli_epi16(v, 4), mask));
        __m128i d = _mm_loadu_si128((const __m128i*)(dst + i));
        _mm_storeu_si128((__m128i*)(dst + i),
                         _mm_xor_si128(d, _mm_xor_si128(l, h)));
    }
    for (; i < len; i++) dst[i] ^= row[src[i]];
}
#endif

void cv_gf_mul_xor(uint8_t* dst, const uint8_t* src, size_t len,
                   uint8_t coef) {
    if (coef == 0) return;
    if (coef == 1) {          // a plain XOR: the compiler vectorises it
        for (size_t i = 0; i < len; i++) dst[i] ^= src[i];
        return;
    }
    const uint8_t* row = gf_mul_table[coef];
#if defined(__x86_64__) || defined(__i386__)
    if (gf_have_ssse3) {
        gf_mul_xor_ssse3(dst, src, len, row);
        return;
    }
#endif
    for (size_t i = 0; i < len; i++) dst[i] ^= row[src[i]];
}

}  // extern "C"
