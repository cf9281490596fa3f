"""Field utilities: div(B) diagnostic and vector-potential initializers
(reference: src/utils.c:8-17 — compute_div_b, vecpot2b1i/b2i/b3i).

The reference initializes divergence-free interface fields by Simpson-rule
line integrals of a user vector potential along cell edges (utils.c
vecpot2b*i with qsimp).  Here the same contract is met with exact
edge integrals evaluated by fixed-order Gauss-Legendre quadrature over
whole-grid coordinate arrays — for the polynomial/trigonometric potentials
of the standard problems (field_loop, cpaw, linear_wave) this matches the
adaptive Simpson result to roundoff.
"""

from __future__ import annotations

import numpy as np

from ..config import GridConfig

# 5-point Gauss-Legendre nodes/weights on [0, 1]
_GL_X, _GL_W = np.polynomial.legendre.leggauss(5)
_GL_X = 0.5 * (_GL_X + 1.0)
_GL_W = 0.5 * _GL_W


def vecpot_to_b_interface(A, grid: GridConfig):
    """(B1i, B2i, B3i) padded interface fields from a vector potential.

    A: (A1, A2, A3) — callables A_i(x1, x2, x3) on numpy arrays, or None.
    Each face's normal field is the circulation of A around the face
    divided by its area (Stokes — the vecpot2b*i contract, utils.c), so
    the discrete div(B) of compute_div_b vanishes to roundoff.  Edge
    integrals along inactive axes degenerate to point values times the
    (full-domain) axis length, cancelling in pairs.
    """
    shape = grid.padded_shape()
    dx = grid.dx
    act = [grid.active(a) for a in range(3)]
    f = [np.asarray(grid.fc_coords(a))[: shape[2 - a]] for a in range(3)]
    base = [
        np.broadcast_to(f[0][None, None, :], shape),
        np.broadcast_to(f[1][None, :, None], shape),
        np.broadcast_to(f[2][:, None, None], shape),
    ]

    def edge_int(fn, p0, axis):
        """Integral of fn along the axis-edge starting at p0 (length =
        dx[axis]; inactive axis -> constant * length)."""
        if fn is None:
            return 0.0
        L = dx[axis]
        if not act[axis]:
            return fn(*p0) * L
        tot = 0.0
        for x, w in zip(_GL_X, _GL_W):
            p = list(p0)
            p[axis] = p0[axis] + x * L
            tot = tot + w * fn(*p)
        return tot * L

    def shift(p, axis):
        q = list(p)
        q[axis] = q[axis] + (dx[axis] if act[axis] else 0.0)
        return q

    def face_circ(n):
        t1, t2 = (n + 1) % 3, (n + 2) % 3
        At1, At2 = (A[t1], A[t2])
        p = base
        circ = (edge_int(At1, p, t1)
                - edge_int(At1, shift(p, t2), t1)
                + edge_int(At2, shift(p, t1), t2)
                - edge_int(At2, p, t2))
        if np.isscalar(circ) and circ == 0.0:
            return np.zeros(shape)
        return np.asarray(circ) / (dx[t1] * dx[t2])

    return face_circ(0), face_circ(1), face_circ(2)


def compute_div_b(B1i, B2i, B3i, grid: GridConfig):
    """Cell-centered divergence of the interface field (utils.c
    compute_div_b): div = sum_a (B_ai[i+1] - B_ai[i])/dx_a over active
    cells (upper faces live one index up inside the padding)."""
    import jax.numpy as jnp
    div = jnp.zeros_like(B1i)
    for a, Bi in ((0, B1i), (1, B2i), (2, B3i)):
        if grid.active(a):
            div = div + (jnp.roll(Bi, -1, axis=2 - a) - Bi) / grid.dx[a]
    sl = grid.interior()
    return div[sl]
