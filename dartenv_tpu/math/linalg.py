"""Small dense linear algebra, unrolled for static tiny sizes.

The reference leans on Eigen (SURVEY.md §2.4 L0) for n<=30 dense factorizations
inside the constraint solver.  Under vmap, generic LAPACK-style
routines with pivoting are hostile to batching, so we unroll Cholesky at
trace time over the static size: every scalar op becomes one fused
elementwise op over the env batch axis with no control flow.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


# above this size, unrolled graphs bloat compile time; XLA's blocked
# implementations are compile-size O(1) and batch fine
_UNROLL_MAX = 12


def chol(A, eps: float = 0.0):
    """Cholesky factor L (lower) of SPD A.

    A: (..., n, n).  `eps` is added to the diagonal (regularization / CFM).
    Small n: trace-time unrolled (pure elementwise ops over the env batch);
    large n: `jnp.linalg.cholesky` (blocked, compile-size O(1)).
    """
    n = A.shape[-1]
    if n > _UNROLL_MAX:
        eye = jnp.eye(n, dtype=A.dtype)
        # relative jitter in f32: guards PSD-ness against rounding in the
        # batched assembly (the unrolled path guards via max(s, tiny))
        rel = 1e-6 if A.dtype == jnp.float32 else 0.0
        scale = jnp.mean(jnp.diagonal(A, axis1=-2, axis2=-1), axis=-1)
        return jnp.linalg.cholesky(
            A + (eps + rel * scale)[..., None, None] * eye
        )
    rows = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            if j == i:
                s = s + eps
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                rows[i][j] = s / rows[j][j]
    zero = jnp.zeros_like(A[..., 0, 0])
    full = [
        jnp.stack([rows[i][j] if j <= i else zero for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(full, axis=-2)


def chol_solve(L, b):
    """Solve (L L^T) x = b with unrolled forward/back substitution.

    L: (..., n, n) lower, b: (..., n) or (..., n, m).
    """
    n = L.shape[-1]
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    if n > _UNROLL_MAX:
        y = jax.lax.linalg.triangular_solve(
            L, b, left_side=True, lower=True, transpose_a=False
        )
        x = jax.lax.linalg.triangular_solve(
            L, y, left_side=True, lower=True, transpose_a=True
        )
        return x[..., 0] if vec else x
    # forward: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y[i] = s / L[..., i, i, None]
    # backward: L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    out = jnp.stack(x, axis=-2)
    return out[..., 0] if vec else out


def _tri_inv_unrolled(L):
    """Inverse of lower-triangular L (..., n, n), n <= _UNROLL_MAX.

    Unrolled forward substitution on identity columns: every entry is one
    fused elementwise op over the batch axes — the same batch-friendly shape
    discipline as `chol`.
    """
    n = L.shape[-1]
    X = [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(j, n):
            if i == j:
                X[i][j] = 1.0 / L[..., i, i]
            else:
                s = L[..., i, j] * X[j][j]
                for k in range(j + 1, i):
                    s = s + L[..., i, k] * X[k][j]
                X[i][j] = -s / L[..., i, i]
    zero = jnp.zeros_like(L[..., 0, 0])
    rows = [
        jnp.stack([X[i][j] if j <= i else zero for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def _pmm(a, b):
    """Precision-safe batched matmul as mul+reduce: default-f32 matmuls
    may run in a reduced-precision matrix unit (TF32 on the GPU) — fatal
    inside an explicit inverse (the error squares).  mul+reduce stays in
    full-f32 math and is
    layout-friendly for these tiny (n <= ~50) matrices."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _inv_psd_rec(A):
    n = A.shape[-1]
    if n <= _UNROLL_MAX:
        Li = _tri_inv_unrolled(chol(A))
        return _pmm(jnp.swapaxes(Li, -1, -2), Li)
    # SPD block inversion via the Schur complement: all ops are unrolled
    # tiny factorizations or batched mul+reduce contractions —
    # compile-size O(n/k) graphs and no XLA cholesky/triangular-solve
    # custom calls (whether cuSOLVER's batched factorization beats this
    # form on the GPU is not measured yet; ROADMAP.md)
    k = (n + 1) // 2
    A11 = A[..., :k, :k]
    A12 = A[..., :k, k:]
    A22 = A[..., k:, k:]
    i11 = _inv_psd_rec(A11)
    U = _pmm(i11, A12)
    S = A22 - _pmm(jnp.swapaxes(A12, -1, -2), U)
    i22 = _inv_psd_rec(S)
    B12 = -_pmm(U, i22)
    B11 = i11 - _pmm(B12, jnp.swapaxes(U, -1, -2))
    top = jnp.concatenate([B11, B12], axis=-1)
    bot = jnp.concatenate([jnp.swapaxes(B12, -1, -2), i22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def inv_psd(A, eps: float = 0.0):
    """Explicit inverse of SPD A (..., n, n).

    For n <= _UNROLL_MAX: unrolled Cholesky + unrolled triangular inverse.
    Larger n: recursive 2x2 Schur-complement block inversion over the
    unrolled leaves.  In f32 a relative diagonal jitter guards PSD-ness
    (same policy as `chol`'s blocked branch).
    """
    n = A.shape[-1]
    if eps or A.dtype == jnp.float32:
        rel = 1e-6 if A.dtype == jnp.float32 else 0.0
        scale = jnp.mean(jnp.diagonal(A, axis1=-2, axis2=-1), axis=-1)
        A = A + (eps + rel * scale)[..., None, None] * jnp.eye(
            n, dtype=A.dtype)
    return _inv_psd_rec(A)


def solve_psd(A, b, eps: float = 0.0):
    """Solve A x = b for SPD A.

    Small n: unrolled Cholesky + substitution.  n > _UNROLL_MAX: explicit
    `inv_psd` + matmul, avoiding the batched XLA triangular-solve custom
    calls (see inv_psd), and the LCP operators here carry CFM
    regularization, so the inverse's extra conditioning cost is within the
    solver tolerance.
    """
    n = A.shape[-1]
    if n > _UNROLL_MAX:
        Ainv = inv_psd(A, eps=eps)
        vec = b.ndim == A.ndim - 1
        if vec:
            return jnp.sum(Ainv * b[..., None, :], axis=-1)
        return _pmm(Ainv, b)
    return chol_solve(chol(A, eps=eps), b)
