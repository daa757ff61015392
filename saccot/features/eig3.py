"""Closed-form symmetric 3x3 eigendecomposition, batched and branchless.

`jnp.linalg.eigvalsh/eigh` lower to iterative routines. For 3x3
symmetric matrices the spectrum has an exact trigonometric solution
(Cardano; Smith 1961) and the eigenvector of a simple eigenvalue is a
cross product of two rows of (A - lambda I) — all elementwise math, no
iteration, `vmap`/`jit`-friendly.

Accuracy: eigenvalues match `eigvalsh` to ~7e-5 relative on covariance
inputs (f32); the ISS saliency ratios and PCA normals consume them
robustly (their thresholds are O(1e-2) quantities). Not a general
replacement where tight eigenpair accuracy is required.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def _normalized_form(C: jnp.ndarray):
    """B = (C - q I) / p with q = tr/3, p = sqrt(tr((C-qI)^2)/6).

    Returns (B entries..., q, p, iso) where iso flags (near-)isotropic
    matrices (p ~ 0: all eigenvalues equal q) whose B is meaningless.
    """
    a = C[..., 0, 0]
    b = C[..., 1, 1]
    c = C[..., 2, 2]
    d = C[..., 0, 1]
    e = C[..., 1, 2]
    f = C[..., 0, 2]
    q = (a + b + c) / 3.0
    p1 = d * d + e * e + f * f
    p2 = (a - q) ** 2 + (b - q) ** 2 + (c - q) ** 2 + 2.0 * p1
    iso = p2 <= 1e-30
    p = jnp.sqrt(jnp.where(iso, 1.0, p2) / 6.0)
    inv_p = 1.0 / p
    B00 = (a - q) * inv_p
    B11 = (b - q) * inv_p
    B22 = (c - q) * inv_p
    B01 = d * inv_p
    B12 = e * inv_p
    B02 = f * inv_p
    return (B00, B11, B22, B01, B12, B02), q, jnp.where(iso, 0.0, p), iso


def _beta_angles(Bd):
    """phi such that the normalized eigenvalues are 2cos(phi + {0,2pi/3,4pi/3})."""
    B00, B11, B22, B01, B12, B02 = Bd
    detB = (
        B00 * (B11 * B22 - B12 * B12)
        - B01 * (B01 * B22 - B12 * B02)
        + B02 * (B01 * B12 - B11 * B02)
    )
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    return jnp.arccos(r) / 3.0


def eigvals3_sym(C: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric [..., 3, 3], ascending [..., 3]."""
    Bd, q, p, _ = _normalized_form(C)
    phi = _beta_angles(Bd)
    e1 = q + 2.0 * p * jnp.cos(phi)                 # largest
    e3 = q + 2.0 * p * jnp.cos(phi + _TWO_PI_3)     # smallest
    e2 = 3.0 * q - e1 - e3
    return jnp.stack([e3, e2, e1], axis=-1)


def _nullspace_vec(Bd, beta):
    """Largest-norm row-pair cross of (B - beta I): spans the 1-D null
    space of a simple eigenvalue's shifted matrix. Returns (v, norm2)."""
    B00, B11, B22, B01, B12, B02 = Bd
    r0 = jnp.stack([B00 - beta, B01, B02], axis=-1)
    r1 = jnp.stack([B01, B11 - beta, B12], axis=-1)
    r2 = jnp.stack([B02, B12, B22 - beta], axis=-1)
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best12 = n12 >= jnp.maximum(n01, n02)
    best02 = n02 >= n01
    v = jnp.where(
        best12[..., None], c12, jnp.where(best02[..., None], c02, c01)
    )
    return v, jnp.maximum(jnp.maximum(n01, n02), n12)


def extreme_eigvecs3_sym(C: jnp.ndarray):
    """(v_small, v_large): unit eigenvectors of the smallest and largest
    eigenvalues of symmetric [..., 3, 3] — the two axes SHOT's local
    reference frame consumes (the middle axis is their cross product).

    Degenerate spectra (repeated eigenvalues / isotropic neighborhoods)
    fall back to a fixed orthonormal pair — exactly the regime where the
    LRF is ill-defined and `eigh` would return an arbitrary basis too;
    v_large is re-orthogonalized against v_small so the frame stays
    orthonormal under f32 rounding.
    """
    Bd, q, p, iso = _normalized_form(C)
    phi = _beta_angles(Bd)
    beta1 = 2.0 * jnp.cos(phi)              # largest (normalized)
    beta3 = 2.0 * jnp.cos(phi + _TWO_PI_3)  # smallest

    vs, ns = _nullspace_vec(Bd, beta3)
    vl, nl = _nullspace_vec(Bd, beta1)

    bad_s = (ns <= 1e-20) | iso
    bad_l = (nl <= 1e-20) | iso
    ez = jnp.zeros_like(vs).at[..., 2].set(1.0)
    ex = jnp.zeros_like(vs).at[..., 0].set(1.0)
    vs = jnp.where(bad_s[..., None], ez, vs)
    vs = vs / jnp.sqrt(
        jnp.maximum(jnp.sum(vs * vs, axis=-1, keepdims=True), 1e-30))
    vl = jnp.where(bad_l[..., None], ex, vl)
    # Orthogonalize against vs (they are exactly orthogonal in theory;
    # this pins it in f32 and rescues the repeated-eigenvalue case).
    vl = vl - jnp.sum(vl * vs, axis=-1, keepdims=True) * vs
    deg = jnp.sum(vl * vl, axis=-1) <= 1e-20
    alt = jnp.cross(vs, ez)
    alt_ok = jnp.sum(alt * alt, axis=-1) > 1e-12
    fallback = jnp.where(alt_ok[..., None], alt, jnp.cross(vs, ex))
    vl = jnp.where(deg[..., None], fallback, vl)
    vl = vl / jnp.sqrt(
        jnp.maximum(jnp.sum(vl * vl, axis=-1, keepdims=True), 1e-30))
    return vs, vl


def smallest_eigvec3_sym(
    C: jnp.ndarray, evals: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue, [..., 3].

    v spans the 1-D null space of M = B - beta3 I (the *normalized* form —
    much better conditioned than A - lambda I when the covariances are
    tiny): the cross product of the two most independent rows. All three
    row-pair crosses are formed and the largest-norm one selected
    branchlessly; a (near-)isotropic or rank-deficient-degenerate
    neighborhood falls back to e_z (any vector is an eigenvector there).
    """
    Bd, q, p, iso = _normalized_form(C)
    B00, B11, B22, B01, B12, B02 = Bd
    phi = _beta_angles(Bd)
    beta3 = 2.0 * jnp.cos(phi + _TWO_PI_3)

    m00 = B00 - beta3
    m11 = B11 - beta3
    m22 = B22 - beta3
    r0 = jnp.stack([m00, B01, B02], axis=-1)
    r1 = jnp.stack([B01, m11, B12], axis=-1)
    r2 = jnp.stack([B02, B12, m22], axis=-1)

    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)

    best12 = n12 >= jnp.maximum(n01, n02)
    best02 = n02 >= n01
    v = jnp.where(
        best12[..., None], c12, jnp.where(best02[..., None], c02, c01)
    )
    nv = jnp.sum(v * v, axis=-1, keepdims=True)
    bad = (nv[..., 0] <= 1e-20) | iso
    ez = jnp.zeros_like(v).at[..., 2].set(1.0)
    v = jnp.where(bad[..., None], ez, v)
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True),
                                    1e-30))
