/* Binary code bit-packing for wire transmission.
 *
 * The codec emits one z_dim-wide vector of {0,1} code bits per frame, of
 * which only the first k (= bits/frame) carry information (bit-priority
 * masking, reference bvrnn.py:104-106).  These routines pack/unpack the
 * first k bits of every frame into a contiguous bitstream — the payload a
 * real-time deployment puts on the wire (k bits per 11.6 ms frame).
 *
 * Variable bitrate: `bits_per_frame` is per-frame, so mid-stream bitrate
 * switches pack exactly the transmitted bits.
 *
 * Built as a plain shared object (no Python headers needed); called via
 * ctypes with a pure-numpy fallback (bvsc_tpu_torch/ops/bitpack.py).
 */

#include <stddef.h>
#include <stdint.h>

/* codes: frames*z_dim uint8 (0/1); bits_per_frame: frames ints;
 * out: byte buffer of capacity >= ceil(sum(bits)/8), zero-initialised by
 * the caller.  Returns the number of bytes written. */
long bvsc_pack(const uint8_t *codes, const int32_t *bits_per_frame,
               long frames, long z_dim, uint8_t *out) {
  long bitpos = 0;
  for (long t = 0; t < frames; ++t) {
    const uint8_t *row = codes + t * z_dim;
    int32_t k = bits_per_frame[t];
    if (k > z_dim) k = (int32_t)z_dim;
    if (k < 0) k = 0;
    for (int32_t b = 0; b < k; ++b, ++bitpos) {
      if (row[b])
        out[bitpos >> 3] |= (uint8_t)(1u << (bitpos & 7));
    }
  }
  return (bitpos + 7) >> 3;
}

/* Inverse: fills codes (frames*z_dim float32) with unpacked bits; bits
 * beyond k get the uninformative midpoint 0.5 (reference bvrnn.py:129).
 * `payload_len` is the byte length of `packed`; returns -1 (without
 * reading past the buffer) if the requested bits exceed it, else the
 * number of payload bytes consumed. */
long bvsc_unpack(const uint8_t *packed, long payload_len,
                 const int32_t *bits_per_frame,
                 long frames, long z_dim, float *codes) {
  long bitpos = 0;
  long payload_bits = payload_len << 3;
  for (long t = 0; t < frames; ++t) {
    float *row = codes + t * z_dim;
    int32_t k = bits_per_frame[t];
    if (k > z_dim) k = (int32_t)z_dim;
    if (k < 0) k = 0;
    if (bitpos + k > payload_bits) return -1;
    for (long b = 0; b < z_dim; ++b) {
      if (b < k) {
        row[b] = (packed[bitpos >> 3] >> (bitpos & 7)) & 1u ? 1.0f : 0.0f;
        ++bitpos;
      } else {
        row[b] = 0.5f;
      }
    }
  }
  return (bitpos + 7) >> 3;
}
