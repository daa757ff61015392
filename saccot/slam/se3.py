"""Batched SE(3) Lie-group operations in JAX (float32, branchless).

The SLAM layer optimizes on the SE(3) manifold with right-multiplicative
increments T <- T * exp(xi). Everything here is batched over leading dims
and uses Taylor-guarded closed forms so jit/vmap/grad all work, including
second derivatives through exp/log (the pose-graph Jacobians come from
autodiff of these).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

# Pose algebra must NOT run at a reduced default matmul precision: a GPU
# may run f32 dot/einsum in TF32, which rounds composed rotation entries
# to ~10 mantissa bits (~1e-3 relative). That error is larger than a
# near-converged SLAM solve's residuals, so every GN step "increases" the
# true cost and the LM guard rejects it. All products here are tiny
# 3x3/4x4 contractions, so HIGHEST is cheap.
_es = functools.partial(jnp.einsum, precision=lax.Precision.HIGHEST)


def _mm(a, b):
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)

# Taylor-guard threshold on theta^2. Must be large for float32: the closed
# forms cancel catastrophically long before they overflow — (1 - cos t)
# rounds to exactly 0 once t^2 < ulp(1) ~ 1.2e-7, making B = 0 and
# A/(2B) = inf -> NaN inside log_se3 for any near-identity transform (the
# fixed point GN converges to, so this is the *common* case, not a corner).
# Below theta = 0.1 the 2-term Taylor series are accurate to ~1e-9 relative
# while the closed forms have already lost ~3 digits to cancellation; switch
# there.
_EPS = 1e-2


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def _sinc_coeffs(theta2: jnp.ndarray):
    """Taylor-guarded A = sin(t)/t, B = (1-cos t)/t^2, C = (t - sin t)/t^3."""
    small = theta2 < _EPS
    t2 = jnp.where(small, 1.0, theta2)  # safe denominator
    t = jnp.sqrt(t2)
    # Two-term Taylor below the guard (see _EPS): error ~ t^4 terms, i.e.
    # <= 1e-6 relative at the threshold — better than the cancelled closed
    # forms there.
    A = jnp.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                  jnp.sin(t) / t)
    B = jnp.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                  (1.0 - jnp.cos(t)) / t2)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                  (t - jnp.sin(t)) / (t2 * t))
    return A, B, C


def exp_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues, batched: [..., 3] -> [..., 3, 3]."""
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    W = hat(w)
    A, B, _ = _sinc_coeffs(theta2)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + A * W + B * _mm(W, W)


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 3]; robust near 0, usable to ~pi - 1e-3.

    AD-safe at theta = 0 (the fixed point Gauss-Newton converges to): theta
    comes from atan2 of the antisymmetric part — no arccos, whose derivative
    is singular at +-1 and poisons `jacfwd` with NaNs — and every singular
    quotient is double-where-guarded so untaken branches never emit NaN
    primals. Derivatives near pi are NOT supported (values are).
    """
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    cos = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # |v| = 2 sin(theta); the +1e-30 keeps the sqrt's derivative finite at 0.
    sin = 0.5 * jnp.sqrt(jnp.sum(v * v, axis=-1) + 1e-30)
    theta = jnp.arctan2(sin, cos)
    small = theta < 1e-4
    near_pi = theta > jnp.pi - 1e-3
    sin_safe = jnp.where(small, 1.0, sin)
    scale_generic = theta / (2.0 * sin_safe)
    scale_small = 0.5 + theta**2 / 12.0
    w_generic = jnp.where(small[..., None], scale_small[..., None], scale_generic[..., None]) * v
    # Near pi the v-based formula loses the axis (sin -> 0). R + I has every
    # column proportional to the axis; take the one with the largest
    # diagonal entry (best conditioned), normalize, and align its sign with
    # v (v = 2 sin(theta) * axis points along +axis below pi). At exactly
    # pi either sign is a valid log.
    C = R + jnp.eye(3, dtype=R.dtype)
    D = jnp.diagonal(R, axis1=-2, axis2=-1)
    j = jnp.argmax(D, axis=-1)
    col = jnp.take_along_axis(C, j[..., None, None], axis=-1)[..., 0]  # [..., 3]
    axis = col / jnp.maximum(jnp.linalg.norm(col, axis=-1, keepdims=True), 1e-12)
    s = jnp.where(jnp.sum(axis * v, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    w_pi = axis * s * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def exp_se3(xi: jnp.ndarray) -> jnp.ndarray:
    """Twist [..., 6] (v, w) -> [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    W = hat(w)
    A, B, C = _sinc_coeffs(theta2)
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = I + A * W + B * _mm(W, W)
    V = I + B * W + C * _mm(W, W)
    t = _es("...ij,...j->...i", V, v)
    return pack(R, t)


def log_se3(T: jnp.ndarray) -> jnp.ndarray:
    """[..., 4, 4] -> twist [..., 6] (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    W = hat(w)
    A, B, _ = _sinc_coeffs(theta2)
    I = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/t^2)(1 - A/(2B)) W^2, Taylor-guarded.
    small = theta2 < _EPS
    t2 = jnp.where(small, 1.0, theta2)
    coef = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / t2)
    Vinv = I - 0.5 * W + coef * _mm(W, W)
    v = _es("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([v, w], axis=-1)


def pack(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    return T.at[..., 3, 3].set(1.0)


def inv(T: jnp.ndarray) -> jnp.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return pack(Rt, -_es("...ij,...j->...i", Rt, t))


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return _es("...ij,...jk->...ik", A, B)


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint [..., 6, 6] for the (v, w) twist ordering of exp_se3.

    T exp(xi^) T^{-1} = exp((adjoint(T) xi)^):
        Ad(T) = [[R, hat(t) R], [0, R]].
    Used to transport an information matrix between perturbation frames —
    e.g. the estimator's information (right perturbation of T_est) to the
    pose-graph residual r = log(Z^{-1} T_i^{-1} T_j) with Z = inv(T_est):
    T_est = T_true exp(d) gives Z = exp(-d) Z_true, so
    r = Ad(Z_true^{-1}) d and H_r = Ad(Z)^T H Ad(Z)
    (verified by Monte-Carlo in tests/test_slam.py).
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    top = jnp.concatenate([R, _mm(hat(t), R)], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def apply(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """[..., 4, 4] x [..., N, 3] -> [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return _es("...ij,...nj->...ni", R, pts) + t[..., None, :]
