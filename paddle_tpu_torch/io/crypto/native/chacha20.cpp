// ChaCha20-Poly1305 (RFC 7539/8439) for model-file encryption.
//
// The port's copy of paddle_tpu's io/crypto/native/chacha20.cpp, built by
// paddle_tpu_torch/io/crypto with the host C++ compiler. Paddle's own
// capability is an AES cipher for saved programs and parameters
// (paddle/fluid/framework/io/crypto/cipher.cc, CryptoPP AES-CBC/GCM).
// This build is dependency-free, so the cipher is ChaCha20: a public
// RFC-specified design that is small enough to implement exactly and is
// not table-driven (no cache-timing side channels). Integrity is the
// RFC 8439 AEAD construction with empty AAD: Poly1305 keyed by the
// counter-0 keystream block (data encryption starts at counter 1) over
// ciphertext || pad16 || le64(aad_len=0) || le64(ct_len).
//
// C ABI (ctypes): all functions return 0 on success.
//   pd_chacha20_xor(key32, nonce12, counter, buf, n)   in-place XOR
//   pd_chacha20_mac(key32, nonce12, buf, n, tag16)     AEAD-style tag
//   pd_poly1305(key32, msg, n, tag16)                  raw Poly1305

#include <stdint.h>
#include <string.h>

namespace {

inline uint32_t rotl(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

inline uint32_t load32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

inline void store32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

#define QR(a, b, c, d)        \
  a += b; d ^= a; d = rotl(d, 16); \
  c += d; b ^= c; b = rotl(b, 12); \
  a += b; d ^= a; d = rotl(d, 8);  \
  c += d; b ^= c; b = rotl(b, 7)

void chacha20_block(const uint8_t key[32], const uint8_t nonce[12],
                    uint32_t counter, uint8_t out[64]) {
  // RFC 7539 §2.3: constants | key | counter | nonce
  uint32_t st[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u};
  for (int i = 0; i < 8; ++i) st[4 + i] = load32(key + 4 * i);
  st[12] = counter;
  for (int i = 0; i < 3; ++i) st[13 + i] = load32(nonce + 4 * i);

  uint32_t x[16];
  memcpy(x, st, sizeof(x));
  for (int round = 0; round < 10; ++round) {  // 20 rounds = 10 double
    QR(x[0], x[4], x[8], x[12]);
    QR(x[1], x[5], x[9], x[13]);
    QR(x[2], x[6], x[10], x[14]);
    QR(x[3], x[7], x[11], x[15]);
    QR(x[0], x[5], x[10], x[15]);
    QR(x[1], x[6], x[11], x[12]);
    QR(x[2], x[7], x[8], x[13]);
    QR(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; ++i) store32(out + 4 * i, x[i] + st[i]);
}

// Poly1305 (RFC 7539 §2.5), 26-bit-limb schoolbook form: h = (h + m) * r
// mod 2^130 - 5 per 16-byte block, then h + s mod 2^128.
struct Poly1305 {
  uint32_t r[5], s4[4];   // clamped r; s4[i] = r[i+1] * 5
  uint32_t h[5] = {0, 0, 0, 0, 0};
  uint8_t pad[16];        // key high half, added at the end
  uint8_t buf[16];
  uint64_t buflen = 0;

  explicit Poly1305(const uint8_t key[32]) {
    uint32_t t0 = load32(key), t1 = load32(key + 4), t2 = load32(key + 8),
             t3 = load32(key + 12);
    r[0] = t0 & 0x3ffffff;
    r[1] = ((t0 >> 26) | (t1 << 6)) & 0x3ffff03;
    r[2] = ((t1 >> 20) | (t2 << 12)) & 0x3ffc0ff;
    r[3] = ((t2 >> 14) | (t3 << 18)) & 0x3f03fff;
    r[4] = (t3 >> 8) & 0x00fffff;
    for (int i = 0; i < 4; ++i) s4[i] = r[i + 1] * 5;
    memcpy(pad, key + 16, 16);
  }

  void block(const uint8_t m[16], uint32_t hibit) {
    uint32_t t0 = load32(m), t1 = load32(m + 4), t2 = load32(m + 8),
             t3 = load32(m + 12);
    h[0] += t0 & 0x3ffffff;
    h[1] += ((t0 >> 26) | (t1 << 6)) & 0x3ffffff;
    h[2] += ((t1 >> 20) | (t2 << 12)) & 0x3ffffff;
    h[3] += ((t2 >> 14) | (t3 << 18)) & 0x3ffffff;
    h[4] += (t3 >> 8) | hibit;
    uint64_t d[5];
    d[0] = (uint64_t)h[0] * r[0] + (uint64_t)h[1] * s4[3] +
           (uint64_t)h[2] * s4[2] + (uint64_t)h[3] * s4[1] +
           (uint64_t)h[4] * s4[0];
    d[1] = (uint64_t)h[0] * r[1] + (uint64_t)h[1] * r[0] +
           (uint64_t)h[2] * s4[3] + (uint64_t)h[3] * s4[2] +
           (uint64_t)h[4] * s4[1];
    d[2] = (uint64_t)h[0] * r[2] + (uint64_t)h[1] * r[1] +
           (uint64_t)h[2] * r[0] + (uint64_t)h[3] * s4[3] +
           (uint64_t)h[4] * s4[2];
    d[3] = (uint64_t)h[0] * r[3] + (uint64_t)h[1] * r[2] +
           (uint64_t)h[2] * r[1] + (uint64_t)h[3] * r[0] +
           (uint64_t)h[4] * s4[3];
    d[4] = (uint64_t)h[0] * r[4] + (uint64_t)h[1] * r[3] +
           (uint64_t)h[2] * r[2] + (uint64_t)h[3] * r[1] +
           (uint64_t)h[4] * r[0];
    uint64_t c = 0;
    for (int i = 0; i < 5; ++i) {
      d[i] += c;
      h[i] = d[i] & 0x3ffffff;
      c = d[i] >> 26;
    }
    h[0] += static_cast<uint32_t>(c * 5);
    c = h[0] >> 26;
    h[0] &= 0x3ffffff;
    h[1] += static_cast<uint32_t>(c);
  }

  void update(const uint8_t* m, uint64_t n) {
    if (buflen) {
      uint64_t take = 16 - buflen < n ? 16 - buflen : n;
      memcpy(buf + buflen, m, take);
      buflen += take;
      m += take;
      n -= take;
      if (buflen == 16) {
        block(buf, 1u << 24);
        buflen = 0;
      }
    }
    while (n >= 16) {
      block(m, 1u << 24);
      m += 16;
      n -= 16;
    }
    if (n) {
      memcpy(buf, m, n);
      buflen = n;
    }
  }

  void final(uint8_t tag[16]) {
    if (buflen) {   // short last block: append 1, zero-pad, hibit = 0
      uint8_t last[16] = {0};
      memcpy(last, buf, buflen);
      last[buflen] = 1;
      block(last, 0);
    }
    uint32_t c;
    c = h[1] >> 26; h[1] &= 0x3ffffff; h[2] += c;
    c = h[2] >> 26; h[2] &= 0x3ffffff; h[3] += c;
    c = h[3] >> 26; h[3] &= 0x3ffffff; h[4] += c;
    c = h[4] >> 26; h[4] &= 0x3ffffff; h[0] += c * 5;
    c = h[0] >> 26; h[0] &= 0x3ffffff; h[1] += c;
    // g = h + 5 - 2^130; pick g when h >= p (no borrow out of g4)
    uint32_t g[5];
    g[0] = h[0] + 5; c = g[0] >> 26; g[0] &= 0x3ffffff;
    g[1] = h[1] + c; c = g[1] >> 26; g[1] &= 0x3ffffff;
    g[2] = h[2] + c; c = g[2] >> 26; g[2] &= 0x3ffffff;
    g[3] = h[3] + c; c = g[3] >> 26; g[3] &= 0x3ffffff;
    g[4] = h[4] + c - (1u << 26);
    uint32_t mask = (g[4] >> 31) - 1;   // all-ones iff no borrow
    for (int i = 0; i < 5; ++i) h[i] = (h[i] & ~mask) | (g[i] & mask);
    // serialize to 128 bits, add the pad with carry
    uint32_t t0 = h[0] | (h[1] << 26);
    uint32_t t1 = (h[1] >> 6) | (h[2] << 20);
    uint32_t t2 = (h[2] >> 12) | (h[3] << 14);
    uint32_t t3 = (h[3] >> 18) | (h[4] << 8);
    uint64_t f;
    f = (uint64_t)t0 + load32(pad);            store32(tag, (uint32_t)f);
    f = (uint64_t)t1 + load32(pad + 4) + (f >> 32);
    store32(tag + 4, (uint32_t)f);
    f = (uint64_t)t2 + load32(pad + 8) + (f >> 32);
    store32(tag + 8, (uint32_t)f);
    f = (uint64_t)t3 + load32(pad + 12) + (f >> 32);
    store32(tag + 12, (uint32_t)f);
  }
};

}  // namespace

extern "C" {

int pd_chacha20_xor(const uint8_t* key, const uint8_t* nonce,
                    uint32_t counter, uint8_t* buf, uint64_t n) {
  uint8_t block[64];
  uint64_t off = 0;
  while (off < n) {
    chacha20_block(key, nonce, counter++, block);
    uint64_t take = n - off < 64 ? n - off : 64;
    for (uint64_t i = 0; i < take; ++i) buf[off + i] ^= block[i];
    off += take;
  }
  return 0;
}

// Raw Poly1305 (exported for RFC 7539 §2.5.2 vector tests).
int pd_poly1305(const uint8_t* key, const uint8_t* msg, uint64_t n,
                uint8_t tag[16]) {
  Poly1305 p(key);
  p.update(msg, n);
  p.final(tag);
  return 0;
}

// RFC 8439 §2.8 AEAD tag (empty AAD): Poly1305 keyed by the counter-0
// keystream block over ct || pad16(ct) || le64(0) || le64(len(ct)).
// Encryption starts at counter 1, so the one-time key block is never
// reused as keystream.
int pd_chacha20_mac(const uint8_t* key, const uint8_t* nonce,
                    const uint8_t* buf, uint64_t n, uint8_t tag[16]) {
  uint8_t otk[64];
  chacha20_block(key, nonce, 0, otk);
  Poly1305 p(otk);
  p.update(buf, n);
  static const uint8_t zeros[16] = {0};
  if (n % 16) p.update(zeros, 16 - (n % 16));
  uint8_t lens[16];
  memset(lens, 0, 8);                       // aad length = 0
  for (int i = 0; i < 8; ++i)
    lens[8 + i] = static_cast<uint8_t>(n >> (8 * i));
  p.update(lens, 16);
  p.final(tag);
  return 0;
}

}  // extern "C"
