"""Frozen operation and byte counts of the anti-aliased activations
(``Activation1d``: 2x kaiser-sinc upsampling, a snake, 2x low-pass
decimation, 12 taps each), and their least time on one H100.

N input elements (B x C x T, summed over the calls) take:

* bytes: the input read once and the output written once, 8 N at float32
  (the 12 taps are negligible);
* operations: 48 N, the 6-tap polyphase upsampling of 2N outputs (24 N,
  a multiply-add is 2) and the 12-tap decimation of N outputs (24 N); the
  snake's elementwise work is left out, as ``counts`` leaves it out.

At the H100's peaks (``counts``) the bytes bound it.
"""

from __future__ import annotations

from portbench.counts import BYTES, PEAK_BYTES_S, PEAK_FLOPS

FLOPS_PER_ELEMENT = 48


def aa_bound_s(elements: int, dtype: str = "float32") -> tuple[float, str]:
    """Least time of the activations over ``elements`` input elements:
    their bytes at HBM bandwidth or their operations at ``dtype``'s peak,
    whichever is longer.  Returns (seconds, which)."""
    t_bytes = 2 * BYTES[dtype] * elements / PEAK_BYTES_S
    t_ops = FLOPS_PER_ELEMENT * elements / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
