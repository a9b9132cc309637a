"""PGS kernel equivalence in interpret mode (CPU).

The Triton-route PGS kernel (lcp/pallas_pgs.py) must match the XLA
reference sweep (lcp/pgs.py) on the same problems, with its rows padded
to a power of two and its env batch padded to whole tiles.
`interpret=True` runs the kernel logic on CPU; the GPU runs the compiled
kernel through the same call sites (make_pgs_solver / make_hybrid_solver
batch rules), and chip_smoke.py compares it there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dartenv_tpu.lcp.hybrid import comp_residual
from dartenv_tpu.lcp.pallas_pgs import padded_rows, pgs_solve_pallas
from dartenv_tpu.lcp.pgs import pgs_solve


def _problems(B=8, nc=4, nl=5, seed=0):
    rng = np.random.default_rng(seed)
    m = 3 * nc + nl
    findex = -np.ones(m, dtype=np.int64)
    for s in range(nc):
        findex[3 * s + 1] = 3 * s
        findex[3 * s + 2] = 3 * s
    As, bs, los, his, mus, acts = [], [], [], [], [], []
    for _ in range(B):
        G = rng.normal(size=(m, m + 4))
        As.append(G @ G.T / (m + 4) + 1e-5 * np.eye(m))
        bs.append(rng.normal(size=m))
        lo = np.zeros(m)
        hi = np.full(m, 1e20)
        for s in range(nc):
            lo[3 * s + 1:3 * s + 3] = -1e20
        los.append(lo)
        his.append(hi)
        mu = np.zeros(m)
        for s in range(nc):
            mu[3 * s + 1:3 * s + 3] = 0.8
        mus.append(mu)
        acts.append((rng.uniform(size=m) > 0.2).astype(np.float64))
    f32 = lambda x: jnp.asarray(np.stack(x), jnp.float32)
    return (f32(As), f32(bs), f32(los), f32(his), f32(mus), f32(acts),
            findex)


def test_pallas_pgs_matches_xla_sweeps():
    A, b, lo, hi, mu, act, findex = _problems(seed=1)
    lam_ref = jax.vmap(
        lambda *a: pgs_solve(a[0], a[1], a[2], a[3], findex, a[4], a[5],
                             iters=20)
    )(A, b, lo, hi, mu, act)
    lam_pal = pgs_solve_pallas(A, b, lo, hi, findex, mu, act, iters=20,
                               interpret=True)
    # identical sweep order => near-bitwise agreement
    np.testing.assert_allclose(np.asarray(lam_pal), np.asarray(lam_ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nc,nl,B", [
    (1, 2, 3),      # m=5 -> 8 rows, B=3 < one tile
    (4, 5, 33),     # m=17 -> 32 rows, B=33 = one tile + 1
    (8, 0, 8),      # m=24 (walker2d's count) -> 32 rows
    (2, 2, 32),     # m=8: already a power of two, B = one whole tile
])
def test_pallas_pgs_row_and_env_padding(nc, nl, B):
    """Non-power-of-two m and B: pad rows (active=0, unit diagonal) stay
    pinned at 0 and never perturb the real rows, and pad envs never
    leak into real ones — the kernel equals the XLA sweep, with and
    without the fused residual."""
    A, b, lo, hi, mu, act, findex = _problems(B=B, nc=nc, nl=nl,
                                              seed=10 + B)
    m = b.shape[1]
    assert padded_rows(m) >= m and padded_rows(m) & (padded_rows(m) - 1) == 0
    lam0 = 0.1 * jnp.abs(b)
    lam_ref = jax.vmap(
        lambda *a: pgs_solve(a[0], a[1], a[2], a[3], findex, a[4], a[5],
                             iters=6, lam0=a[6])
    )(A, b, lo, hi, mu, act, lam0)
    lam, res = pgs_solve_pallas(A, b, lo, hi, findex, mu, act, iters=6,
                                lam0=lam0, interpret=True,
                                return_residual=True)
    assert lam.shape == (B, m) and res.shape == (B,)
    np.testing.assert_allclose(np.asarray(lam), np.asarray(lam_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(res),
        np.asarray(comp_residual(A, b, lam, lo, hi, findex, mu, act)),
        rtol=1e-4, atol=1e-7)


def test_padded_rows():
    assert [padded_rows(m) for m in (1, 2, 3, 24, 32, 41, 47)] == \
        [1, 2, 4, 32, 32, 64, 64]


def test_pallas_pgs_fused_residual_matches_metric():
    """The kernel's fused residual output equals the reference metric
    (lcp.hybrid.comp_residual) on the kernel's own solution."""
    from dartenv_tpu.lcp.hybrid import comp_residual

    A, b, lo, hi, mu, act, findex = _problems(seed=4)
    lam, res = pgs_solve_pallas(A, b, lo, hi, findex, mu, act, iters=10,
                                interpret=True, return_residual=True)
    res_ref = comp_residual(A, b, lam, lo, hi, findex, mu, act)
    np.testing.assert_allclose(np.asarray(res), np.asarray(res_ref),
                               rtol=1e-4, atol=1e-7)


def test_hybrid_escalate_kmax_caps_batch():
    """escalate_kmax bounds the escalation batch without breaking the
    solve: with kmax=2 on an 8-problem batch, results remain valid LCP
    points and the worst offenders still improve across repeated solves
    (the ranking-persistence property)."""
    from dartenv_tpu.lcp.hybrid import comp_residual, make_hybrid_solver

    A, b, lo, hi, mu, act, findex = _problems(seed=6)
    solver = make_hybrid_solver(findex, iters=3, escalate_frac=1.0,
                                escalate_tol=1e-6, escalate_iters=12,
                                escalate_kmax=2)
    lam0 = jnp.zeros_like(b)
    lam = jax.vmap(solver)(A, b, lo, hi, mu, act, lam0)
    r1 = np.asarray(comp_residual(A, b, lam, lo, hi, findex, mu, act))
    # second pass warm-started from the first: the next-worst offenders
    # get escalated now
    lam2 = jax.vmap(solver)(A, b, lo, hi, mu, act, lam)
    r2 = np.asarray(comp_residual(A, b, lam2, lo, hi, findex, mu, act))
    assert np.isfinite(np.asarray(lam2)).all()
    assert np.sort(r2)[-1] <= np.sort(r1)[-1] + 1e-7   # tail not worse
    assert (np.sort(r2)[:4] < 1e-4).all()              # escalated ones clean
