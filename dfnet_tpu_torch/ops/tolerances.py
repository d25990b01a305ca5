"""How closely a NeRF kernel must agree with its plain version: the one
source of these limits for chip_smoke.py and the tests.

The kernels and the plain versions accumulate in float32 in different
orders, so an activation that sits on a bf16 rounding midpoint can round
the other way; at the trained nets' large activations one such flip moves
an output by more than TOL_RAW. A FLIP_SHARE of the elements may therefore
fall outside the tolerance, none by more than FLIP_CAP times it.
"""

TOL_RAW = 2e-2          # raw pre-activation outputs, atol and rtol
TOL_COMP = 3e-2         # composited outputs, atol and rtol
TOL_Z = 2e-3            # fine z samples, absolute (tests/test_fast_render.py:239)
FLIP_SHARE = 1e-5
FLIP_CAP = 10.0
# Gradients of raw_bwd_t against raw_bwd_plain: 3e-2 of each packed entry's
# largest magnitude. Both round the cotangents to bf16, so a ReLU mask or
# bf16 rounding flip moves a term, and the kernel sums over points in
# another order (WMMA tiles within a chunk of points, then the chunks'
# float32 partials in chunk order).
TOL_GRAD = 3e-2
