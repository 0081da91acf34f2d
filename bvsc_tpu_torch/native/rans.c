/* Binary rANS (range asymmetric numeral system) entropy coder.
 *
 * A copy of bvsc_tpu/native/rans.c: the same integer arithmetic, so the
 * same bits and probabilities give the same bytes in both packages.
 *
 * Two users: the prior coder of .bvsc files (bvsc_tpu_torch/entropy.py)
 * codes the transmitted first-k bits of each frame against the BVRNN's
 * own prior P(z_t | h_t), and the BVSP entropy wire option
 * (bvsc_tpu_torch/serve/entropy_wire.py) codes them against integer
 * adaptive counts.
 *
 * Scheme: ryg-style byte-renormalised rANS, uint32 state in
 * [2^23, 2^31), 16-bit probability scale (M = 65536).  The encoder
 * processes symbols in REVERSE so the decoder can stream FORWARD, which
 * the adaptive prior requires, since P(z_t) is computable only after
 * z_{<t} are decoded.  Probabilities are pre-quantised uint16
 * P(bit==1) in [16, 65520]; encoder and decoder must be fed bit-identical
 * values (each model above guarantees this on its own).
 *
 * Built from source on first use into bvsc_tpu_torch/_build/ (never a
 * checked-in binary); the numpy mirror in bvsc_tpu_torch/ops/rans.py
 * produces byte-identical streams.
 */

#include <stddef.h>
#include <stdint.h>

#define RANS_L ((uint32_t)1 << 23) /* lower renorm bound */
#define PROB_SCALE 65536u          /* M = 2^16 */

/* Encode n bits (uint8 0/1) with per-bit P(bit==1) in p1 (uint16,
 * clamped to [1, 65535] by the caller).  Writes the final byte stream
 * (decoder-forward order) into out; returns bytes written, or -1 if cap
 * would be exceeded.  Worst case ~12.0 bits/symbol + 4 flush bytes. */
long bvsc_rans_encode(const uint8_t *bits, const uint16_t *p1, long n,
                      uint8_t *out, long cap) {
  uint32_t x = RANS_L;
  long pos = 0; /* bytes emitted so far (reverse order) */
  for (long i = n - 1; i >= 0; --i) {
    uint32_t f1 = p1[i];
    uint32_t f = bits[i] ? f1 : PROB_SCALE - f1;
    uint32_t c = bits[i] ? PROB_SCALE - f1 : 0;
    /* renormalise: keep x < f << (23+8-16) so the transform stays < 2^31 */
    uint32_t x_max = f << 15;
    while (x >= x_max) {
      if (pos >= cap) return -1;
      out[pos++] = (uint8_t)(x & 0xFF);
      x >>= 8;
    }
    x = ((x / f) << 16) + (x % f) + c;
  }
  /* flush state (4 bytes, low first — reversed below with the rest) */
  for (int k = 0; k < 4; ++k) {
    if (pos >= cap) return -1;
    out[pos++] = (uint8_t)(x & 0xFF);
    x >>= 8;
  }
  /* reverse into decoder-forward order */
  for (long a = 0, b = pos - 1; a < b; ++a, --b) {
    uint8_t t = out[a];
    out[a] = out[b];
    out[b] = t;
  }
  return pos;
}

/* Streaming decoder state lives in caller memory: st[0] = x, st[1] = pos. */
long bvsc_rans_dec_init(const uint8_t *buf, long len, uint64_t *st) {
  if (len < 4) return -1;
  st[0] = ((uint64_t)buf[0] << 24) | ((uint64_t)buf[1] << 16) |
          ((uint64_t)buf[2] << 8) | (uint64_t)buf[3];
  st[1] = 4;
  return 0;
}

/* Decode k bits with per-bit P(bit==1).  Returns 0, or -1 on truncated
 * input (state renormalisation ran past len). */
long bvsc_rans_dec_bits(const uint8_t *buf, long len, uint64_t *st,
                        const uint16_t *p1, long k, uint8_t *out) {
  uint32_t x = (uint32_t)st[0];
  long pos = (long)st[1];
  for (long i = 0; i < k; ++i) {
    uint32_t f1 = p1[i];
    uint32_t f0 = PROB_SCALE - f1;
    uint32_t slot = x & 0xFFFF;
    uint32_t bit = slot >= f0;
    uint32_t f = bit ? f1 : f0;
    uint32_t c = bit ? f0 : 0;
    x = f * (x >> 16) + slot - c;
    while (x < RANS_L) {
      if (pos >= len) return -1;
      x = (x << 8) | buf[pos++];
    }
    out[i] = (uint8_t)bit;
  }
  st[0] = x;
  st[1] = (uint64_t)pos;
  return 0;
}
