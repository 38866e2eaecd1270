// Native host-side sampling core for tpufhe_torch: the port's own copy of
// tpufhe/native/tpufhe_native.cpp, built with g++ by
// tpufhe_torch/native/__init__.py.
//
// Bit-exact C++ implementations of the deterministic randomness stack
// (rand_chacha 0.9 ChaCha8 word stream, rand 0.9 Lemire uniform sampling,
// fhe-util's centered-binomial bit pool — see tpufhe_torch/utils/rngs.py
// and tpufhe_torch/utils/sampling.py for the Python implementations and
// the fhe.rs citations). Key generation and encryption draw megabytes from
// these streams; the pure-Python versions dominate host time, and this
// library produces identical bytes (tests/test_torch_native.py).
//
// Stream-state protocol shared by the consuming entry points:
//   counter_io — the counter of the NEXT block to generate; the current
//                (partially consumed) block, when any, is counter_io-1.
//   wordpos_io — next unread 32-bit word within the current block (0..15);
//                16 means "no current block, refill before reading".

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t rotl(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }

void chacha_block(const uint32_t key[8], uint64_t counter, uint64_t stream,
                  uint32_t rounds, uint32_t out[16]) {
  uint32_t s[16] = {
      0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
      key[0], key[1], key[2], key[3], key[4], key[5], key[6], key[7],
      (uint32_t)(counter & 0xFFFFFFFFu), (uint32_t)(counter >> 32),
      (uint32_t)(stream & 0xFFFFFFFFu), (uint32_t)(stream >> 32)};
  uint32_t x[16];
  memcpy(x, s, sizeof(x));
#define QR(a, b, c, d)                                                     \
  x[a] += x[b]; x[d] = rotl(x[d] ^ x[a], 16);                              \
  x[c] += x[d]; x[b] = rotl(x[b] ^ x[c], 12);                              \
  x[a] += x[b]; x[d] = rotl(x[d] ^ x[a], 8);                               \
  x[c] += x[d]; x[b] = rotl(x[b] ^ x[c], 7);
  for (uint32_t r = 0; r < rounds / 2; ++r) {
    QR(0, 4, 8, 12) QR(1, 5, 9, 13) QR(2, 6, 10, 14) QR(3, 7, 11, 15)
    QR(0, 5, 10, 15) QR(1, 6, 11, 12) QR(2, 7, 8, 13) QR(3, 4, 9, 14)
  }
#undef QR
  for (int i = 0; i < 16; ++i) out[i] = x[i] + s[i];
}

struct Stream {
  const uint32_t* key;
  uint64_t stream;
  uint32_t rounds;
  uint64_t counter;
  uint32_t wp;
  uint32_t buf[16];

  Stream(const uint32_t* k, uint64_t st, uint32_t r, uint64_t c, uint32_t w)
      : key(k), stream(st), rounds(r), counter(c), wp(w) {
    if (wp < 16) chacha_block(key, counter - 1, stream, rounds, buf);
  }
  uint32_t next_u32() {
    if (wp >= 16) {
      chacha_block(key, counter, stream, rounds, buf);
      counter++;
      wp = 0;
    }
    return buf[wp++];
  }
  uint64_t next_u64() {
    uint64_t lo = next_u32();
    uint64_t hi = next_u32();
    return lo | (hi << 32);
  }
};

}  // namespace

extern "C" {

// nblocks raw 64-byte blocks starting at counter0 (does not touch state).
void chacha_blocks(const uint32_t* key, uint64_t counter0, uint64_t stream,
                   uint32_t rounds, uint64_t nblocks, uint8_t* out) {
  for (uint64_t i = 0; i < nblocks; ++i) {
    uint32_t b[16];
    chacha_block(key, counter0 + i, stream, rounds, b);
    memcpy(out + 64 * i, b, 64);
  }
}

// rand 0.9 UniformInt<u64>::sample: widening multiply, reject while the
// low word is below (2^64 - bound) % bound (rngs.py uniform_u64_below).
void chacha_uniform_u64(const uint32_t* key, uint64_t stream, uint32_t rounds,
                        uint64_t* counter_io, uint32_t* wordpos_io,
                        uint64_t bound, uint64_t nvals, uint64_t* out) {
  Stream s(key, stream, rounds, *counter_io, *wordpos_io);
  const uint64_t thresh = (0 - bound) % bound;
  for (uint64_t i = 0; i < nvals; ++i) {
    for (;;) {
      uint64_t v = s.next_u64();
      unsigned __int128 prod = (unsigned __int128)v * bound;
      if ((uint64_t)prod >= thresh) {
        out[i] = (uint64_t)(prod >> 64);
        break;
      }
    }
  }
  *counter_io = s.counter;
  *wordpos_io = s.wp;
}

// fhe-util sample_vec_cbd: 4*variance bits per coefficient from a LE bit
// pool fed 64 bits at a time (sampling.py).
void chacha_cbd(const uint32_t* key, uint64_t stream, uint32_t rounds,
                uint64_t* counter_io, uint32_t* wordpos_io, uint32_t variance,
                uint64_t n, int64_t* out) {
  Stream s(key, stream, rounds, *counter_io, *wordpos_io);
  const uint32_t number_bits = 4 * variance;
  const uint64_t mask_add = (number_bits == 64)
                                ? (~0ull >> (2 * variance))
                                : (((1ull << number_bits) - 1) >> (2 * variance));
  const uint64_t mask_sub = mask_add << (2 * variance);
  unsigned __int128 pool = 0;
  uint32_t pool_nbits = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (pool_nbits < number_bits) {
      pool |= (unsigned __int128)s.next_u64() << pool_nbits;
      pool_nbits += 64;
    }
    uint64_t low = (uint64_t)pool;
    out[i] = __builtin_popcountll(low & mask_add) -
             __builtin_popcountll(low & mask_sub);
    pool >>= number_bits;
    pool_nbits -= number_bits;
  }
  *counter_io = s.counter;
  *wordpos_io = s.wp;
}

}  // extern "C"
