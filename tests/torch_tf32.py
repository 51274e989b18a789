"""The float32 kernels' tensor-core arithmetic (3xTF32 on mma.sync), in
numpy, for the CPU tests of ``csrc/flash_attention.cu`` and
``csrc/mamba2_ssd.cu``.

A float32 kernel splits every operand x into hi = tf32(x) and lo = tf32(x
- hi), rounded as cvt.rna.tf32.f32 rounds, and takes each product from hi
* hi and the small terms lo * hi and hi * lo, 8 deep a tensor-core step.
Each mma is modelled as one float32 rounding of the accumulator plus its 8
exact products.  The kernels run only on a card; here their arithmetic
runs in numpy.
"""

import numpy as np


def tf32(x):
    """cvt.rna.tf32.f32: add 0x1000 to the float32 magnitude's bits, clear
    the low 13 (to nearest, ties away from zero)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma_chain(acc, pairs, parity=None):
    """acc [..., M, N] += x @ y for each (x [..., M, K], y [..., K, N]) of
    ``pairs``, 8 deep a step, one mma a step and pair, in that order;
    ``parity`` 0 or 1 takes the even or the odd steps alone."""
    steps = range(0, pairs[0][0].shape[-1], 8)
    if parity is not None:
        steps = steps[parity::2]
    for k0 in steps:
        for x, y in pairs:
            prod = x[..., k0:k0 + 8].astype(np.float64) @ \
                y[..., k0:k0 + 8, :].astype(np.float64)
            acc = (acc.astype(np.float64) + prod).astype(np.float32)
    return acc

