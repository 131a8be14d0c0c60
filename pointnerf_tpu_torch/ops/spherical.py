"""Real spherical harmonics basis evaluation.

Counterpart of `pointnerf_tpu/ops/spherical.py` (`sh_basis`, `sh_eval`),
used by the `sh_intrp` distance kernel (`models/aggregator._dist_weight`):
the closed-form bands up to degree 4 (16 coefficients), and above that the
associated-Legendre recurrence, in the same convention (Condon-Shortley
phase folded into P, band-major m = -l..l ordering).
"""
from __future__ import annotations

import math

import torch

# band constants (standard real SH normalization)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def _sh_basis_recurrence(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Arbitrary-degree real SH via associated-Legendre recurrences:
      Y_l^{-m} = sqrt(2) K_l^m sin(m phi) P_l^m,  Y_l^0 = K_l^0 P_l^0,
      Y_l^{+m} = sqrt(2) K_l^m cos(m phi) P_l^m.
    sin^m(theta) cos/sin(m phi) ride the planar recurrence
    A_m = x A_{m-1} - y B_{m-1}, B_m = x B_{m-1} + y A_{m-1}; the sin^m
    factor divides out of P via Ptilde_l^m = P_l^m / sin^m(theta), a
    polynomial in z."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = torch.ones_like(x)
    A = [one]                    # sin^m cos(m phi)
    B = [torch.zeros_like(x)]    # sin^m sin(m phi)
    for m in range(1, degree):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(x * B[m - 1] + y * A[m - 1])
    ptil = {}                    # (m, l): P_l^m / sin^m(theta)
    for m in range(degree):
        pmm = one * (((-1.0) ** m) * math.prod(range(1, 2 * m, 2)))
        ptil[(m, m)] = pmm
        if m + 1 < degree:
            ptil[(m, m + 1)] = (2 * m + 1) * z * pmm
        for l in range(m + 2, degree):
            ptil[(m, l)] = ((2 * l - 1) * z * ptil[(m, l - 1)]
                            - (l + m - 1) * ptil[(m, l - 2)]) / (l - m)
    out = []
    for l in range(degree):
        for m in range(-l, l + 1):
            am = abs(m)
            k = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - am) / math.factorial(l + am))
            p = ptil[(am, l)]
            if m < 0:
                out.append((math.sqrt(2.0) * k) * (B[am] * p))
            elif m == 0:
                out.append(k * p)
            else:
                out.append((math.sqrt(2.0) * k) * (A[am] * p))
    return torch.stack(out, -1)


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """The first `degree`² real SH basis functions of unit directions
    dirs [..., 3] -> [..., degree²]: closed forms for degrees 1-4, the
    Legendre recurrence above."""
    if degree < 1:
        raise ValueError(f"sh degree {degree} unsupported (>= 1)")
    if degree > 4:
        return _sh_basis_recurrence(degree, dirs)
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * xz, _C2[4] * (xx - yy)]
    if degree > 3:
        out += [_C3[0] * y * (3 * xx - yy), _C3[1] * xy * z,
                _C3[2] * y * (4 * zz - xx - yy),
                _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                _C3[4] * x * (4 * zz - xx - yy),
                _C3[5] * z * (xx - yy), _C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def sh_eval(coeffs: torch.Tensor, dirs: torch.Tensor, degree: int
            ) -> torch.Tensor:
    """Weighted SH reconstruction: coeffs [..., degree², C] x basis."""
    b = sh_basis(degree, dirs)
    return torch.sum(coeffs * b[..., None], -2)
