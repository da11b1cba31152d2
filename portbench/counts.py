"""The least work of the cells' evaluations, and the card's published peaks.

``bound_ops`` is chip_smoke.py's count, copied: the floating-point
operations one evaluation of the collapsed bound with its gradient needs at
(n, m, d), worked out from the shapes, whatever the kernel computes.
"""

from __future__ import annotations

__all__ = ["PEAK_F32_OPS", "PEAK_BYTES", "bound_ops"]

# NVIDIA H100 SXM data sheet (at 700 W): float32 outside the tensor cores,
# and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ops(n, m, d, want_z=False):
    """The least floating-point operations one evaluation of the collapsed
    bound with its gradient needs at (n, m, d). A multiply-add is 2,
    exp/log/sqrt/divide 1 each. A symmetric result is counted once per pair,
    and a product with a triangular factor at its triangular count (LAPACK's:
    potrf, trtri and lauum m^3/3 each, trmm and syrk n m^2, sygst m^3)."""
    ops = (3 * (n + m) * d                     # scaled inputs, their norms
           + n * m * (2 * d + 6)               # Knm: cross products, r2, exp
           + m * (m + 1) / 2 * (2 * d + 6)     # Kmm (symmetric)
           + 4 * m ** 3 / 3                    # potrf + trtri of Kmm and of B
           + n * m * m + n * m                 # An = Knm L^-T / sigma (trmm)
           + n * m * m + n * m                 # B = An^T An + I (syrk)
           + m ** 3 / 3                        # B^-1 = VB VB^T (lauum)
           + 4 * n * m + 3 * m * m + 3 * n     # u, alpha; three substitutions
           + m ** 3 + m * m                    # Y1 = (I - B^-1) L^-1 (trmm)
           + 2 * m * m + m ** 3                # T0 = 2I - B - B^-1 (symmetric); L^-T T0 L^-1 (sygst)
           + 2 * m * m                         # dKmm, Pmm (symmetric)
           + 2 * n * m * m + 5 * n * m         # dKnm = (An Y1 + alpha w^T) / sigma, Pnm
           + m * m + 2 * n * m                 # sums of Pmm (rows = columns) and of Pnm
           + 2 * m * m * d + 2 * n * m * d     # Pmm Zs, Pnm Zs
           + 6 * (n + m) * d)                  # chain rule to the lengthscales
    if want_z:
        ops += 2 * n * m * d + 6 * m * d       # Pnm^T Xs, dU/dZ
    return float(ops)
