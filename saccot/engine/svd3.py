"""Batched weighted rigid alignment (Horn/Umeyama) for the jitted engine.

Replaces the reference's per-sample Eigen 3x3 SVD (SURVEY.md section 2.1,
"Guided sampler + 3-pt solver") with a fully batched, branchless version:
one `jnp.linalg.svd` over a [K, 3, 3] stack of cross-covariances computes all
K hypothesis transforms at once. The det<0 reflection case is fixed by a
sign flip on the last singular vector (no control flow, vmap/jit safe), and
degenerate inputs (collinear/coincident triples, all-zero weights) are
guarded so they produce *a* valid rotation rather than NaNs — such
hypotheses are then discarded by scoring, never by control flow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def umeyama(
    p: jnp.ndarray,
    q: jnp.ndarray,
    w: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
    method: str = "quat",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted rigid alignment, batched over leading dims.

    Finds (R, t) minimizing sum_i w_i ||R p_i + t - q_i||^2 (no scale).

    Args:
      p: [..., M, 3] source points.
      q: [..., M, 3] target points.
      w: [..., M] nonnegative weights (default uniform). An all-zero weight
         row yields R=I-ish garbage-but-finite output, not NaN.
      axis_name: if set (inside shard_map/pmap), the point axis M is sharded
        across that mesh axis — all moment sums are psum-reduced so every
        device gets the global fit. This is how the SP refinement path runs
        (SURVEY.md section 2.2).
      method: "quat" (default) — Horn's quaternion method solved by a
        branchless shifted matrix-power iteration: 5 batched 4x4 squarings
        + a few power steps, all elementwise arithmetic, no data-dependent
        loops (unlike "svd", jnp.linalg.svd's iterative solver), and
        quaternions produce a proper rotation by construction (no
        reflection fix needed).
        "svd" keeps the classic Procrustes path for cross-checking.

    Returns:
      R: [..., 3, 3] rotations, t: [..., 3] translations.
    """
    p = jnp.asarray(p)
    q = jnp.asarray(q)
    if w is None:
        w = jnp.ones(p.shape[:-1], dtype=p.dtype)
    w = w.astype(p.dtype)

    def _reduce(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    wsum = _reduce(jnp.sum(w, axis=-1, keepdims=True))  # [..., 1]
    wsum = jnp.maximum(wsum, 1e-9)
    pbar = _reduce(jnp.sum(w[..., None] * p, axis=-2)) / wsum  # [..., 3]
    qbar = _reduce(jnp.sum(w[..., None] * q, axis=-2)) / wsum
    pc = p - pbar[..., None, :]
    qc = q - qbar[..., None, :]
    # Weighted cross-covariance H = sum_i w_i pc_i qc_i^T  -> [..., 3, 3]
    H = _reduce(
        jnp.einsum(
            "...m,...mi,...mj->...ij", w, pc, qc, precision=jax.lax.Precision.HIGHEST
        )
    )

    if method == "quat":
        R = _quaternion_rotation(H)
    else:
        R = _procrustes_rotation(H)
    t = qbar - jnp.einsum("...ij,...j->...i", R, pbar,
                          precision=jax.lax.Precision.HIGHEST)
    return R, t


def quaternion_from_cross_covariance(
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz
):
    """Optimal-rotation quaternion via Horn's method, structure-of-arrays.

    The rotation maximizing trace(R^T H) is R(q*) where q* is the dominant
    eigenvector of Horn's symmetric 4x4 matrix N(H). We find it with a
    shift-and-square power method: A = N/|N|_F + 1.05 I is PSD with the
    same dominant eigenvector; eight squarings give A^256, whose largest
    column is the eigenvector to ~((l2+s)/(l1+s))^256 accuracy; two plain
    power steps polish.

    Layout: everything runs in structure-of-arrays form — inputs are the 9
    entries of the cross-covariance H as same-shaped arrays, the 10 unique
    entries of the symmetric 4x4 are kept as separate arrays, and the
    squaring is unrolled into elementwise FMAs over the hypothesis batch,
    which XLA fuses into a few elementwise kernels instead of many tiny
    [..., 4, 4] matmuls.

    Degeneracy: for near-collinear point sets the top two eigenvalues of N
    coalesce (the rotation about the line is unobservable) and the returned
    quaternion is an arbitrary member of the optimal set — exactly like SVD
    on the same input. Such hypotheses score badly downstream and are
    rejected, mirroring the reference's degenerate-sample handling.

    Returns (qw, qx, qy, qz), unit up to the iteration tolerance.
    """

    # Upper triangle of Horn's N (symmetric).
    n00 = Sxx + Syy + Szz
    n01 = Syz - Szy
    n02 = Szx - Sxz
    n03 = Sxy - Syx
    n11 = Sxx - Syy - Szz
    n12 = Sxy + Syx
    n13 = Szx + Sxz
    n22 = Syy - Sxx - Szz
    n23 = Syz + Szy
    n33 = Szz - Sxx - Syy

    def fro2(a):
        d = a[0] * a[0] + a[4] * a[4] + a[7] * a[7] + a[9] * a[9]
        o = (a[1] * a[1] + a[2] * a[2] + a[3] * a[3]
             + a[5] * a[5] + a[6] * a[6] + a[8] * a[8])
        return d + 2.0 * o

    n = (n00, n01, n02, n03, n11, n12, n13, n22, n23, n33)
    inv_fro = 1.0 / (jnp.sqrt(fro2(n)) + 1e-12)
    # Minimal PSD shift: normalized eigenvalues lie in [-1, 1], so +1.05
    # makes A PSD while barely compressing the top gap (a large shift would
    # stall the power iteration). Entry order: (00,01,02,03,11,12,13,22,23,33).
    b = tuple(x * inv_fro for x in n)
    B = (b[0] + 1.05, b[1], b[2], b[3], b[4] + 1.05,
         b[5], b[6], b[7] + 1.05, b[8], b[9] + 1.05)

    def square_sym(a):
        """A -> A @ A for symmetric A in upper-triangle SoA form."""
        a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = a
        c00 = a00 * a00 + a01 * a01 + a02 * a02 + a03 * a03
        c01 = a00 * a01 + a01 * a11 + a02 * a12 + a03 * a13
        c02 = a00 * a02 + a01 * a12 + a02 * a22 + a03 * a23
        c03 = a00 * a03 + a01 * a13 + a02 * a23 + a03 * a33
        c11 = a01 * a01 + a11 * a11 + a12 * a12 + a13 * a13
        c12 = a01 * a02 + a11 * a12 + a12 * a22 + a13 * a23
        c13 = a01 * a03 + a11 * a13 + a12 * a23 + a13 * a33
        c22 = a02 * a02 + a12 * a12 + a22 * a22 + a23 * a23
        c23 = a02 * a03 + a12 * a13 + a22 * a23 + a23 * a33
        c33 = a03 * a03 + a13 * a13 + a23 * a23 + a33 * a33
        return (c00, c01, c02, c03, c11, c12, c13, c22, c23, c33)

    A = B
    for _ in range(8):  # A^256, renormalized to avoid overflow
        A = square_sym(A)
        inv = 1.0 / (jnp.sqrt(fro2(A)) + 1e-30)
        A = tuple(x * inv for x in A)

    # Dominant eigenvector ~ the largest column of A^256. For symmetric A,
    # |col_j|^2 = (A^2)_jj — one more (partial) squaring gives the norms.
    a00, a01, a02, a03, a11, a12, a13, a22, a23, a33 = A
    cn0 = a00 * a00 + a01 * a01 + a02 * a02 + a03 * a03
    cn1 = a01 * a01 + a11 * a11 + a12 * a12 + a13 * a13
    cn2 = a02 * a02 + a12 * a12 + a22 * a22 + a23 * a23
    cn3 = a03 * a03 + a13 * a13 + a23 * a23 + a33 * a33
    cols = (
        (a00, a01, a02, a03),
        (a01, a11, a12, a13),
        (a02, a12, a22, a23),
        (a03, a13, a23, a33),
    )
    # Branchless column select: fold a (norm, column) max over the 4 columns.
    best_n, v = cn0, cols[0]
    for cn, col in ((cn1, cols[1]), (cn2, cols[2]), (cn3, cols[3])):
        take = cn > best_n
        best_n = jnp.where(take, cn, best_n)
        v = tuple(jnp.where(take, cj, vj) for cj, vj in zip(col, v))

    b00, b01, b02, b03, b11, b12, b13, b22, b23, b33 = B
    for _ in range(2):  # polish with the shifted original
        v0, v1, v2, v3 = v
        w0 = b00 * v0 + b01 * v1 + b02 * v2 + b03 * v3
        w1 = b01 * v0 + b11 * v1 + b12 * v2 + b13 * v3
        w2 = b02 * v0 + b12 * v1 + b22 * v2 + b23 * v3
        w3 = b03 * v0 + b13 * v1 + b23 * v2 + b33 * v3
        inv = 1.0 / (jnp.sqrt(w0 * w0 + w1 * w1 + w2 * w2 + w3 * w3) + 1e-30)
        v = (w0 * inv, w1 * inv, w2 * inv, w3 * inv)

    return v


def rotation_entries_from_quaternion(qw, qx, qy, qz):
    """Unit quaternion (SoA) -> the 9 rotation-matrix entries, row-major SoA."""
    return (
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy),
        2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx),
        2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy),
    )


def _quaternion_rotation(H: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] cross-covariance -> [..., 3, 3] optimal rotation (SoA core)."""
    qw, qx, qy, qz = quaternion_from_cross_covariance(
        H[..., 0, 0], H[..., 0, 1], H[..., 0, 2],
        H[..., 1, 0], H[..., 1, 1], H[..., 1, 2],
        H[..., 2, 0], H[..., 2, 1], H[..., 2, 2],
    )
    r = rotation_entries_from_quaternion(qw, qx, qy, qz)
    return jnp.stack(r, axis=-1).reshape(qw.shape + (3, 3))


def _procrustes_rotation(H: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation to the polar factor of H^T-aligned frame: R = V D U^T.

    H: [..., 3, 3] cross-covariance. D = diag(1, 1, det(V U^T)) fixes
    reflections branchlessly.
    """
    # Tiny diagonal jitter keeps SVD well-defined for exactly-degenerate H
    # (e.g. padded hypotheses with identical points).
    eye = jnp.eye(3, dtype=H.dtype)
    Hj = H + 1e-12 * eye
    U, _, Vt = jnp.linalg.svd(Hj, full_matrices=False)
    V = jnp.swapaxes(Vt, -1, -2)
    Ut = jnp.swapaxes(U, -1, -2)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", V, Ut,
                                    precision=jax.lax.Precision.HIGHEST))
    # Flip the last column of V by sign(det): R = V diag(1,1,s) U^T.
    s = jnp.sign(det)
    s = jnp.where(s == 0, 1.0, s).astype(H.dtype)
    V_fixed = V.at[..., :, 2].multiply(s[..., None])
    return jnp.einsum("...ij,...jk->...ik", V_fixed, Ut,
                      precision=jax.lax.Precision.HIGHEST)


def transform_from_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Pack [..., 3, 3] + [..., 3] into homogeneous [..., 4, 4]."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T
