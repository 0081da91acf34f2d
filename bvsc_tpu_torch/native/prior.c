/* One dense layer of the prior coder's host pass, in a fixed order.
 *
 * bvsc_tpu_torch/entropy.py runs the BVRNN's prior and closed-loop state
 * advance on the host in float64 so that the probabilities it quantises
 * for rANS are the same bits on both ends of a .bvsc file, whatever the
 * thread count, the batch or the device that made the codes.  A BLAS
 * product cannot promise that: how it splits the sum changes with the
 * threads and the shapes.  This routine sums in one order, always:
 *
 *   out[j] = (((0 + x[0] w[0][j]) + x[1] w[1][j]) + ...) + b[j]
 *
 * each product and each sum rounded once to float64 (built with
 * -ffp-contract=off, so no fused multiply-add merges the two roundings;
 * the loop over j is vectorised, which does not reorder any one sum).
 * The weights stay float32 and widen exactly.  The numpy path of
 * entropy.py computes the same expression in the same order, so both
 * paths give the same bits.
 */

void bvsc_prior_dense(const double *x, const float *w, const float *b, long n_in,
                      long n_out, double *out) {
  for (long j = 0; j < n_out; ++j) out[j] = 0.0;
  for (long i = 0; i < n_in; ++i) {
    const double xi = x[i];
    const float *row = w + i * n_out;
    for (long j = 0; j < n_out; ++j) out[j] = out[j] + xi * (double)row[j];
  }
  for (long j = 0; j < n_out; ++j) out[j] = out[j] + (double)b[j];
}
