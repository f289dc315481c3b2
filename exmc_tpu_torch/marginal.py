"""Laplace marginalization of Markov latent paths (INLA-within-MCMC),
``exmc_tpu/marginal.py``.

    p(y | theta) ~= |Q|^{1/2} |Q + W|^{-1/2} exp(g(s_hat)),
    g(s) = -1/2 s'Qs + sum_t loglik_t(s_t),
    s_hat = argmax g  (damped Newton),  W = diag(-loglik''(s_hat))

Q is the latent prior's precision: TRIDIAGONAL for a random walk or an
AR(1) path, BANDED with bandwidth p for AR(p).

Batching. Every function here works on a leading batch of points: the
hyperparameters (and the leaves of ``theta``) may carry leading axes,
which are chains under NUTS (a ``Custom`` likelihood sees the sampler's
(C,) batch) and grid points under ``sv_inla``. The latent path is then
(..., T), and each leaf of ``theta`` reaches the user's
``loglik(s, theta)`` with a trailing axis of 1, so per-point code such
as ``-s - 0.5 * (nu + 1) * log1p(r**2 * exp(-2 s) / nu)`` broadcasts
against (..., T) unchanged. ``theta``'s leaves are scalars per point.

Scans. The tridiagonal factorization is a Mobius (continued-fraction)
composition of 2x2 matrices and the solves and the Takahashi diagonal
are affine maps; all compose associatively. The JAX package runs each
as a ``lax.scan`` over T/128 blocks of an ``associative_scan``. Here
each is a log-depth doubling (Hillis-Steele) scan on whole tensors:
ceil(log2 T) levels of batched elementwise ops along the time axis, so
a CUDA graph of the whole value-and-grad holds a few thousand small
kernels rather than T steps per recurrence. The 2x2 products stay
explicit multiply-adds (``_mm2``) and each Mobius combine is
renormalized (projective invariance), without which the products
overflow f32 within ~10 steps. The combine order differs from XLA's, so
f32 results differ from the JAX package's in rounding (the tests state
the tolerances); long-T marginals want float64 (``config.x64``, DESIGN
D-T39).

Gradients. With ``implicit_diff=True`` (the default) the mode is a
``torch.autograd.Function``: its forward is the Newton loop without a
graph, its backward one more tridiagonal (or banded) solve at the mode
plus a vector-Jacobian product of the Newton root function
grad_s g(s, p) at the fixed mode (the implicit-function theorem,
D-T37). ``implicit_diff=False`` differentiates through the unrolled
iterations instead. The banded AR(p) kernels are sequential loops over
T, as the JAX package's are sequential scans (validated at T <= ~2000).

This is an APPROXIMATION, exact for Gaussian likelihoods (checked
against the Kalman filter); for the heavy-tailed StudentT SV likelihood
the curvature is floored (W >= w_floor).
"""

import math

import numpy as np
import torch

from exmc_tpu_torch.config import default_dtype, np_dtype, prepare_device
from exmc_tpu_torch.math import cholesky_or_nan, const_like

S_CLAMP = 40.0          # |log-vol| beyond this is numerically absurd


# ---------------------------------------------------------------------------
# log-depth scans along the last (time) axis
# ---------------------------------------------------------------------------

def _mm2(y, x):
    """Batched 2x2 products y @ x (..., 2, 2) as explicit elementwise
    multiply-adds: each entry is the sum of two products."""
    return (y.unsqueeze(-1) * x.unsqueeze(-3)).sum(-2)


def _mv2(m, v):
    """Batched 2x2 @ 2-vector, elementwise for the same reason."""
    return (m * v.unsqueeze(-2)).sum(-1)


def _mobius_combine(x, y):
    """Compose 2x2 Mobius matrices, y AFTER x, renormalized: the
    continued fraction's value is a RATIO of homogeneous coordinates,
    so any per-step rescaling cancels exactly."""
    c = _mm2(y, x)
    scale = c.abs().amax(dim=(-2, -1), keepdim=True)
    return c / torch.clamp_min(scale, 1e-30)


def _mobius_scan(m):
    """Inclusive prefix products P_i = m_i ... m_0 of (..., n, 2, 2)."""
    n = m.shape[-3]
    s = 1
    while s < n:
        tail = _mobius_combine(m[..., : n - s, :, :], m[..., s:, :, :])
        m = torch.cat([m[..., :s, :, :], tail], dim=-3)
        s *= 2
    return m


def _affine_scan(coef, offs, y0):
    """y_i = coef_i * y_{i-1} + offs_i for i >= 1 with y_0 = y0, along
    the last axis; returns (..., T) including y_0."""
    a = torch.cat([torch.zeros_like(coef[..., :1]), coef], dim=-1)
    c = torch.cat([y0.unsqueeze(-1).expand_as(offs[..., :1]), offs], dim=-1)
    a, c = torch.broadcast_tensors(a, c)
    t = c.shape[-1]
    s = 1
    while s < t:
        c = torch.cat([c[..., :s], torch.addcmul(c[..., s:], a[..., s:], c[..., : t - s])],
                      dim=-1)
        if 2 * s < t:
            a = torch.cat([a[..., :s], a[..., s:] * a[..., : t - s]], dim=-1)
        s *= 2
    return c


def _thomas_factor(a, b):
    """LDL' of the SPD tridiagonal with diagonal ``a`` (..., T) and a
    constant sub/super-diagonal ``b`` (..., 1) per point: returns
    (delta, ell), the D diagonal (..., T) and the L sub-diagonal
    multipliers (..., T-1).

    delta_i = a_i - b^2/delta_{i-1} is the Mobius map of
    [[a_i, -b^2], [1, 0]] acting on the homogeneous [delta_{i-1}, 1]."""
    t = a.shape[-1]
    if t == 1:
        return a, a[..., :0]
    b = torch.broadcast_to(b, a[..., :1].shape)
    top = torch.stack([a[..., 1:], torch.broadcast_to(-b * b, a[..., 1:].shape)], dim=-1)
    bottom = torch.stack([torch.ones_like(a[..., 1:]), torch.zeros_like(a[..., 1:])], dim=-1)
    m = torch.stack([top, bottom], dim=-2)                      # (..., T-1, 2, 2)
    v0 = torch.stack([a[..., 0], torch.ones_like(a[..., 0])], dim=-1)
    v0 = v0 / torch.clamp_min(v0.abs().amax(dim=-1, keepdim=True), 1e-30)
    vs = _mv2(_mobius_scan(m), v0.unsqueeze(-2))               # (..., T-1, 2)
    delta = torch.cat([a[..., :1], vs[..., 0] / vs[..., 1]], dim=-1)
    return delta, b / delta[..., :-1]


def _thomas_solve(delta, ell, rhs):
    """Solve (L D L') x = rhs given the factors of _thomas_factor."""
    y = _affine_scan(-ell, rhs[..., 1:], rhs[..., 0])      # y_i = rhs_i - l_i y_{i-1}
    z = y / delta
    # x_i = z_i - l_i x_{i+1}: the same recurrence, reversed, from z_{T-1}
    x_rev = _affine_scan(-ell.flip(-1), z[..., :-1].flip(-1), z[..., -1])
    return x_rev.flip(-1)


def _takahashi_diag(delta, ell):
    """diag((LDL')^-1): Sigma_ii = 1/delta_i + ell_i^2 Sigma_{i+1,i+1},
    run reversed."""
    inv_d = 1.0 / delta
    ell_rev = ell.flip(-1)
    s_rev = _affine_scan(ell_rev * ell_rev, inv_d[..., :-1].flip(-1), inv_d[..., -1])
    return s_rev.flip(-1)


def grw_precision_diag(T, sigma, dtype=None):
    """Diagonal of Q = D'D / sigma^2 for the library's GRW convention
    (x0 ~ N(0, sigma), increments N(0, sigma)): [2, ..., 2, 1] / sigma^2
    (sigma (...) gives (..., T)); the off-diagonal is -1/sigma^2 and
    logdet Q = -2 T log sigma."""
    sigma = torch.as_tensor(sigma, dtype=dtype or default_dtype())
    d = torch.cat([torch.full((T - 1,), 2.0, dtype=sigma.dtype, device=sigma.device),
                   torch.ones(1, dtype=sigma.dtype, device=sigma.device)])
    return d / (sigma * sigma).unsqueeze(-1)


# ---------------------------------------------------------------------------
# the Newton engine, shared by the tridiagonal and banded marginals
# ---------------------------------------------------------------------------

def _leaves(pp, theta):
    """(pp tuple, theta dict) -> (list of tensors, sorted theta keys)."""
    keys = tuple(sorted(theta))
    return list(pp) + [theta[k] for k in keys], keys


class _Engine:
    """Laplace-mode machinery for one latent prior. ``prior`` holds

      q(pp)               -> (q_diag (..., T), factor state)  precision
      factor(q_diag+w, st) -> factor                           LDL'
      solve(factor, rhs)  -> x
      neg_half_quad(s, pp) -> (...)                            -1/2 s'Qs
      qs(s, pp)           -> (..., T)                          Q s

    with pp a tuple of (...) tensors."""

    def __init__(self, loglik, T, prior, newton_iters, w_floor):
        self.loglik, self.T, self.prior = loglik, T, prior
        self.newton_iters, self.w_floor = newton_iters, w_floor

    def theta_in(self, theta):
        return {k: v.unsqueeze(-1) for k, v in theta.items()}

    def ell_sum(self, s, theta):
        return self.loglik(s, self.theta_in(theta)).sum(-1)

    def derivs(self, s, theta):
        """Elementwise first and second derivatives of the loglik."""
        th = self.theta_in(theta)

        def total(x):
            return self.loglik(x, th).sum()

        def g1_sum(x):
            g = torch.func.grad(total)(x)
            return g.sum(), g

        l2, l1 = torch.func.grad(g1_sum, has_aux=True)(s)
        return l1, l2

    def g_of(self, s, pp, theta):
        return self.prior["neg_half_quad"](s, pp) + self.ell_sum(s, theta)

    def grad_g(self, s, pp, theta):
        """grad_s of g(s) = -1/2 s'Qs + sum loglik: the Newton root."""
        return self.derivs(s, theta)[0] - self.prior["qs"](s, pp)

    def factor_at(self, s, pp, theta):
        _, l2 = self.derivs(s, theta)
        w = torch.clamp_min(-l2, self.w_floor)
        q_diag, st = self.prior["q"](pp)
        return self.prior["factor"](q_diag + w, st)

    def newton(self, pp, theta, batch):
        dtype, dev = pp[0].dtype, pp[0].device
        s = torch.zeros(*batch, self.T, dtype=dtype, device=dev)
        q_diag, st = self.prior["q"](pp)
        # 1, 1/4, 1/16, made on the device (no host copy in a capture)
        alphas = torch.pow(0.25, torch.arange(3, dtype=dtype, device=dev)).reshape(
            (3,) + (1,) * (len(batch) + 1))
        g_cur = self.g_of(s, pp, theta)
        for _ in range(self.newton_iters):
            l1, l2 = self.derivs(s, theta)
            w = torch.clamp_min(-l2, self.w_floor)     # SoftAbs-lite curvature floor
            fac = self.prior["factor"](q_diag + w, st)
            s_full = self.prior["solve"](fac, w * s + l1)
            # MONOTONE damping: backtrack the step until g does not
            # decrease (three tries at once), and clamp the iterate; g
            # at the new iterate is the chosen try's
            cand = torch.clamp(s + alphas * (s_full - s), -S_CLAMP, S_CLAMP)
            g_new = self.g_of(cand, pp, theta)
            ok = torch.isfinite(g_new) & (g_new >= g_cur - 1e-3)
            g_cur = torch.where(ok[0], g_new[0], torch.where(ok[1], g_new[1],
                                                             torch.where(ok[2], g_new[2], g_cur)))
            ok = ok.unsqueeze(-1)
            s = torch.where(ok[0], cand[0], torch.where(ok[1], cand[1],
                                                        torch.where(ok[2], cand[2], s)))
        return s


class _Mode(torch.autograd.Function):
    """s_hat = argmax g with the implicit-function-theorem backward:
    v -> (dF/dp)' (Q + W)^{-1} v, F = grad_s g at the fixed mode."""

    @staticmethod
    def forward(ctx, engine, n_pp, keys, batch, *leaves):
        pp, theta = tuple(leaves[:n_pp]), dict(zip(keys, leaves[n_pp:]))
        with torch.no_grad():
            s_hat = engine.newton(pp, theta, batch)
        ctx.engine, ctx.n_pp, ctx.keys = engine, n_pp, keys
        ctx.save_for_backward(s_hat, *leaves)
        return s_hat

    @staticmethod
    def backward(ctx, v):
        s_hat, *leaves = ctx.saved_tensors
        eng, n_pp = ctx.engine, ctx.n_pp
        with torch.enable_grad():
            req = [x.detach().requires_grad_(True) for x in leaves]
            pp, theta = tuple(req[:n_pp]), dict(zip(ctx.keys, req[n_pp:]))
            with torch.no_grad():
                u = eng.prior["solve"](eng.factor_at(s_hat, pp, theta), v)
            grads = torch.autograd.grad(eng.grad_g(s_hat, pp, theta), req,
                                        grad_outputs=u, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        return (None, None, None, None, *grads)


def _as_points(pp, theta, pp_event):
    """Hyperparameters and theta's leaves as tensors of one dtype and
    device (the first tensor's device, else ``"cuda"``), with their
    broadcast batch shape; ``pp_event[i]`` is the number of event axes
    of hyperparameter i (1 for AR(p)'s phis)."""
    dtype = default_dtype()
    found = [x for x in list(pp) + list(theta.values()) if isinstance(x, torch.Tensor)]
    dev = found[0].device if found else prepare_device(None)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    pp = tuple(t(x) for x in pp)
    theta = {k: t(v) for k, v in theta.items()}
    batch = torch.broadcast_shapes(*(x.shape[:x.ndim - k] for x, k in zip(pp, pp_event)),
                                   *(v.shape for v in theta.values()))
    return pp, theta, tuple(batch)


def _make_marginal(loglik, T, prior, newton_iters, w_floor, implicit_diff, log_det,
                   pp_event):
    engine = _Engine(loglik, T, prior, newton_iters, w_floor)

    def marginal(pp, theta):
        pp, theta, batch = _as_points(pp, theta, pp_event)
        if implicit_diff:
            leaves, keys = _leaves(pp, theta)
            s_hat = _Mode.apply(engine, len(pp), keys, batch, *leaves)
        else:
            s_hat = engine.newton(pp, theta, batch)
        fac = engine.factor_at(s_hat, pp, theta)
        # logZ = g_hat + 1/2 logdet Q - 1/2 logdet(Q + W); the
        # (2 pi)^{+-T/2} prior/Laplace constants cancel
        logZ = engine.g_of(s_hat, pp, theta) + log_det(pp) - 0.5 * torch.log(fac[0]).sum(-1)
        return logZ, s_hat, prior["takahashi"](fac)

    return marginal


def _tri_prior(tri, neg_half_quad):
    """A tridiagonal prior from ``tri(pp) -> (q_diag (..., T), b (..., 1))``."""

    def qs(s, pp):
        q_diag, b = tri(pp)
        z = torch.zeros_like(s[..., :1])
        return (q_diag * s + b * torch.cat([s[..., 1:], z], dim=-1)
                + b * torch.cat([z, s[..., :-1]], dim=-1))

    return {"q": tri,
            "factor": lambda a, b: _thomas_factor(a, b),
            "solve": lambda fac, rhs: _thomas_solve(fac[0], fac[1], rhs),
            "takahashi": lambda fac: _takahashi_diag(*fac),
            "neg_half_quad": neg_half_quad, "qs": qs}


def make_grw_marginal(loglik, T, newton_iters=25, w_floor=1e-3, implicit_diff=True):
    """Laplace-marginal log-density for

        s ~ GaussianRandomWalk(sigma) over T steps,
        y_t ~ likelihood with elementwise log-density loglik(s, theta)_t.

    ``loglik(s, theta) -> (..., T)`` must be elementwise in ``s`` (data
    closed over). Returns ``marginal(sigma, theta) -> (logZ, s_hat,
    var_hat)``: logZ (...), the mode (..., T) and its marginal
    variances diag((Q + W)^-1) (..., T), for sigma of shape (...).
    Newton runs a FIXED ``newton_iters`` iterations; see the module
    docstring for batching and for ``implicit_diff``."""

    def tri(pp):
        sigma = pp[0]
        return grw_precision_diag(T, sigma), (-1.0 / (sigma * sigma)).unsqueeze(-1)

    def neg_half_quad(s, pp):
        # -(1/2) s'Qs = -(1/2) ||D s||^2 / sigma^2
        ds = torch.cat([s[..., :1], torch.diff(s, dim=-1)], dim=-1)
        return -0.5 * (ds * ds).sum(-1) / (pp[0] * pp[0])

    base = _make_marginal(loglik, T, _tri_prior(tri, neg_half_quad), newton_iters,
                          w_floor, implicit_diff,
                          lambda pp: -T * torch.log(pp[0]), (0,))   # |D'D| = 1

    def marginal(sigma, theta):
        return base((sigma,), theta)

    return marginal


def make_ar1_marginal(loglik, T, newton_iters=25, w_floor=1e-3, implicit_diff=True):
    """Laplace marginal for a STATIONARY AR(1) latent path:

        s_1 ~ N(0, sigma^2 / (1 - phi^2)),
        s_t = phi s_{t-1} + N(0, sigma^2),   |phi| < 1,

    with ``loglik`` as in make_grw_marginal. Returns
    ``marginal(sigma, phi, theta) -> (logZ, s_hat, var_hat)``,
    differentiable in both hyperparameters. The precision is
    tridiagonal: diag [1, 1+phi^2, ..., 1+phi^2, 1]/sigma^2,
    off-diagonal -phi/sigma^2, logdet Q = log(1-phi^2) - 2T log sigma."""

    def tri(pp):
        sigma, phi = pp
        inv_s2 = (1.0 / (sigma * sigma)).unsqueeze(-1)
        mid = (1.0 + phi * phi).unsqueeze(-1).expand(*phi.shape, T)
        one = torch.ones_like(mid[..., :1])
        d = torch.cat([one, mid[..., 1:-1], one], dim=-1) if T > 1 else one
        return d * inv_s2, -phi.unsqueeze(-1) * inv_s2

    def neg_half_quad(s, pp):
        sigma, phi = pp
        inn = s[..., 1:] - phi.unsqueeze(-1) * s[..., :-1]
        return -0.5 * (s[..., 0] * s[..., 0] * (1.0 - phi * phi)
                       + (inn * inn).sum(-1)) / (sigma * sigma)

    base = _make_marginal(loglik, T, _tri_prior(tri, neg_half_quad), newton_iters,
                          w_floor, implicit_diff,
                          lambda pp: 0.5 * torch.log1p(-pp[1] * pp[1]) - T * torch.log(pp[0]),
                          (0, 0))

    def marginal(sigma, phi, theta):
        return base((sigma, phi), theta)

    return marginal


# ---------------------------------------------------------------------------
# Banded extension: AR(p) latents. Sequential loops over T with a small
# (p, p) state, as the JAX package's length-T scans are.
# ---------------------------------------------------------------------------

def _banded_ldl(q_bands, p):
    """LDL' of an SPD banded matrix. ``q_bands``: (..., p+1, T) with
    q_bands[j, i] = Q[i, i-j] (zero-padded where i < j). Returns
    (d (..., T), l (..., p, T)) with l[j-1, i] = L[i, i-j]."""
    T = q_bands.shape[-1]
    one = torch.ones_like(q_bands[..., 0, 0])
    zero = torch.zeros_like(one)
    # virtual rows i < 0: d = 1, L = 0 (they multiply only the padding)
    d_prev = [one] * p                  # d_prev[m-1] = d[i-m]
    l_prev = [[zero] * p for _ in range(p)]   # l_prev[a-1][m-1] = L[i-a, i-a-m]
    ds, ls = [], []
    for i in range(T):
        li = [zero] * p
        for j in range(p, 0, -1):
            acc = q_bands[..., j, i]
            for m in range(j + 1, p + 1):
                acc = acc - li[m - 1] * d_prev[m - 1] * l_prev[j - 1][m - j - 1]
            li[j - 1] = acc / d_prev[j - 1]
        di = q_bands[..., 0, i]
        for m in range(1, p + 1):
            di = di - li[m - 1] * li[m - 1] * d_prev[m - 1]
        d_prev = [di] + d_prev[:-1]
        l_prev = [li] + l_prev[:-1]
        ds.append(di)
        ls.append(torch.stack(li, dim=-1))
    return torch.stack(ds, dim=-1), torch.stack(ls, dim=-1)


def _lrows(l):
    """(..., p, T): lrows[m-1, i] = L[i+m, i] = l[m-1, i+m]."""
    p = l.shape[-2]
    return torch.stack([torch.cat([l[..., m - 1, m:], torch.zeros_like(l[..., m - 1, :m])],
                                  dim=-1) for m in range(1, p + 1)], dim=-2)


def _banded_solve(d, l, rhs):
    """Solve (L D L') x = rhs with the factors from _banded_ldl."""
    p, T = l.shape[-2], rhs.shape[-1]
    zero = torch.zeros_like(rhs[..., 0])
    carry = [zero] * p
    y = []
    for i in range(T):
        yi = rhs[..., i]
        for m in range(1, p + 1):
            yi = yi - l[..., m - 1, i] * carry[m - 1]
        carry = [yi] + carry[:-1]
        y.append(yi)
    z = torch.stack(y, dim=-1) / d
    lr = _lrows(l)
    carry = [zero] * p
    x = [None] * T
    for i in range(T - 1, -1, -1):
        xi = z[..., i]
        for m in range(1, p + 1):
            xi = xi - lr[..., m - 1, i] * carry[m - 1]
        carry = [xi] + carry[:-1]
        x[i] = xi
    return torch.stack(x, dim=-1)


def _banded_takahashi_diag(d, l):
    """diag((LDL')^-1) for a banded factorization: the Takahashi
    recurrence run in reverse, carrying the trailing (p, p) block of the
    inverse's band."""
    p, T = l.shape[-2], d.shape[-1]
    lr = _lrows(l)
    inv_d = 1.0 / d
    zero = torch.zeros_like(d[..., 0])
    W = [[zero] * p for _ in range(p)]   # W[a][c] = B[i+1+a, i+1+c]
    out = [None] * T
    for i in range(T - 1, -1, -1):
        b_off = [zero] * (p + 1)
        for b in range(p, 0, -1):
            acc = zero
            for m in range(1, p + 1):
                acc = acc - lr[..., m - 1, i] * W[m - 1][b - 1]
            b_off[b] = acc
        acc = inv_d[..., i]
        for m in range(1, p + 1):
            acc = acc - lr[..., m - 1, i] * b_off[m]
        b_off[0] = acc
        W = [[b_off[c] if a == 0 else (b_off[a] if c == 0 else W[a - 1][c - 1])
              for c in range(p)] for a in range(p)]
        out[i] = b_off[0]
    return torch.stack(out, dim=-1)


def _arp_whitener_bands(phis, sigma, T):
    """Band representation (..., T, p+1) of the AR(p) whitening operator
    A (Q = A'A): c[t, k] is A's row-t coefficient for column t-p+k. Rows
    t >= p: [-phi_p, ..., -phi_1, 1]/sigma; rows t < p: the stationary
    block's whitener C^-1 (C = chol of the stationary p x p covariance),
    the EXACT stationary initial distribution. Also returns log|det A|."""
    from exmc_tpu_torch.kalman import ar_ssm

    p = phis.shape[-1]
    C = cholesky_or_nan(ar_ssm(phis, sigma).P0)
    eye = torch.eye(p, dtype=phis.dtype, device=phis.device)
    Cinv = torch.linalg.solve_triangular(C, torch.broadcast_to(eye, C.shape), upper=False)
    row = torch.cat([-phis.flip(-1), torch.ones_like(phis[..., :1])], dim=-1) / sigma.unsqueeze(-1)
    rows = [torch.cat([torch.zeros_like(row[..., : p - t]), Cinv[..., t, : t + 1]], dim=-1)
            for t in range(p)]
    c = torch.cat([torch.stack(rows, dim=-2),
                   row.unsqueeze(-2).expand(*row.shape[:-1], T - p, p + 1)], dim=-2)
    log_det_a = (torch.log(torch.abs(torch.diagonal(Cinv, dim1=-2, dim2=-1))).sum(-1)
                 - (T - p) * torch.log(sigma))
    return c, log_det_a


def _bands_from_whitener(c, p):
    """Q = A'A bands from A's band rep: q_bands[j, i] = Q[i, i-j]."""
    T = c.shape[-2]
    c_pad = torch.cat([c, torch.zeros_like(c[..., :p, :])], dim=-2)
    bands = []
    for j in range(p + 1):
        acc = torch.zeros_like(c[..., 0])
        for u in range(0, p - j + 1):
            acc = acc + c_pad[..., u:u + T, p - u] * c_pad[..., u:u + T, p - u - j]
        bands.append(acc)
    return torch.stack(bands, dim=-2)


def _apply_a(c, s, p):
    """A s from the band rep (for the stable quadratic ||A s||^2)."""
    T = s.shape[-1]
    s_pad = torch.cat([torch.zeros_like(s[..., :p]), s], dim=-1)
    out = torch.zeros_like(s)
    for k in range(p + 1):
        out = out + c[..., k] * s_pad[..., k:k + T]
    return out


def make_arp_marginal(loglik, T, p, newton_iters=25, w_floor=1e-3, implicit_diff=True):
    """Laplace marginal for a STATIONARY AR(p) latent path (banded
    precision, bandwidth p):

        (s_1..s_p) ~ exact stationary distribution,
        s_t = phi_1 s_{t-1} + ... + phi_p s_{t-p} + N(0, sigma^2).

    Returns ``marginal(sigma, phis, theta) -> (logZ, s_hat, var_hat)``,
    differentiable in sigma (...) and phis (..., p), which must be
    stationary. For p == 1 prefer make_ar1_marginal (log-depth scans);
    these banded kernels are sequential loops over T."""

    def bands(pp):
        sigma, phis = pp
        c, log_det_a = _arp_whitener_bands(phis, sigma, T)
        return _bands_from_whitener(c, p), c, log_det_a

    def q(pp):
        qb, _, _ = bands(pp)
        return qb[..., 0, :], qb

    def factor(diag, qb):
        rest = qb[..., 1:, :]
        batch = torch.broadcast_shapes(diag.shape[:-1], rest.shape[:-2])
        return _banded_ldl(torch.cat([diag.expand(*batch, T).unsqueeze(-2),
                                      rest.expand(*batch, p, T)], dim=-2), p)

    def neg_half_quad(s, pp):
        _, c, _ = bands(pp)
        a_s = _apply_a(c, s, p)
        return -0.5 * (a_s * a_s).sum(-1)

    def qs(s, pp):
        # Q s = A'(A s): column i of A has entries c[i+u, p-u], u = 0..p
        _, c, _ = bands(pp)
        a_s = _apply_a(c, s, p)
        as_pad = torch.cat([a_s, torch.zeros_like(a_s[..., :p])], dim=-1)
        c_pad = torch.cat([c, torch.zeros_like(c[..., :p, :])], dim=-2)
        out = torch.zeros_like(s)
        for u in range(p + 1):
            out = out + c_pad[..., u:u + T, p - u] * as_pad[..., u:u + T]
        return out

    prior = {"q": q, "factor": factor,
             "solve": lambda fac, rhs: _banded_solve(fac[0], fac[1], rhs),
             "takahashi": lambda fac: _banded_takahashi_diag(*fac),
             "neg_half_quad": neg_half_quad, "qs": qs}
    base = _make_marginal(loglik, T, prior, newton_iters, w_floor, implicit_diff,
                          lambda pp: bands(pp)[2], (0, 1))

    def marginal(sigma, phis, theta):
        return base((sigma, phis), theta)

    return marginal


# ---------------------------------------------------------------------------
# Stochastic volatility front door
# ---------------------------------------------------------------------------

def _sv_loglik(r):
    """Elementwise StudentT(nu, 0, exp(s)) log-density of returns r, the
    likelihood of ``benchmarks/suite.sv_model``."""
    r_of = const_like(np.asarray(r, np.float64))

    def loglik(s, theta):
        nu = theta["nu"]
        z = r_of(s) / torch.exp(s)
        return (torch.lgamma(0.5 * (nu + 1.0)) - torch.lgamma(0.5 * nu)
                - 0.5 * torch.log(nu * math.pi) - s
                - 0.5 * (nu + 1.0) * torch.log1p(z * z / nu))

    return loglik


def sv_marginal_model(r, newton_iters=25, implicit_diff=True):
    """The suite's SV model with the latent path MARGINALIZED: the free
    RVs are (sigma, nu), with the suite's priors (sigma ~
    Exponential(50), nu ~ Exponential(0.1)), and the likelihood is the
    Laplace marginal, a ``Custom`` term NUTS differentiates through (a
    2-d sampling problem at any T). Returns the IR; sample it with
    ``sample(ir, ncp=False)``, in float64 at long T (``config.x64``)."""
    from exmc_tpu_torch import Builder, dists

    marginal = make_grw_marginal(_sv_loglik(np.asarray(r)), len(r),
                                 newton_iters=newton_iters, implicit_diff=implicit_diff)

    def logpdf(_value, params):
        logZ, _, _ = marginal(params["sigma"], {"nu": params["nu"]})
        return logZ

    lik = dists.Custom(logpdf_fn=logpdf, support="real", align=False)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "sigma", dists.Exponential, {"lambda": 50.0})
    ir = Builder.rv(ir, "nu", dists.Exponential, {"lambda": 0.1})
    ir = Builder.rv(ir, "lik", lik, {"sigma": "sigma", "nu": "nu"})
    ir = Builder.obs(ir, "lik_obs", "lik", 0.0)
    return ir


def sv_inla(r, sigma_grid=None, nu_grid=None, newton_iters=25, grid_batch=None,
            device=None):
    """Full INLA for the SV model: the Laplace marginal on a (sigma, nu)
    grid, normalized to the joint hyperparameter posterior, and the
    conditional latent Gaussians mixed into marginal path estimates.

    The grid's points are one batch of the marginal on ``device``
    (default ``"cuda"``), or batches of ``grid_batch`` points (a short
    last batch pads by wrapping). Returns a dict with the grids and
    posterior, the posterior means/sds of sigma and nu, the latent
    path's marginal mean/sd (mixture over the grid) and ``n_failed``,
    the grid points whose marginal was not finite (they get zero
    weight; all of them failing raises)."""
    dev = prepare_device(device)
    r = np.asarray(r)
    T = len(r)
    if sigma_grid is None:
        sigma_grid = np.geomspace(0.002, 0.2, 40)
    if nu_grid is None:
        nu_grid = np.geomspace(2.0, 80.0, 40)
    marginal = make_grw_marginal(_sv_loglik(r), T, newton_iters=newton_iters)

    sg, ng = np.meshgrid(sigma_grid, nu_grid, indexing="ij")
    flat_s = torch.as_tensor(sg.reshape(-1).astype(np_dtype()), device=dev)
    flat_n = torch.as_tensor(ng.reshape(-1).astype(np_dtype()), device=dev)

    def run(sig, nu):
        with torch.no_grad():
            logZ, s_hat, var_hat = marginal(sig, {"nu": nu})
            # prior sigma ~ Exp(50), nu ~ Exp(0.1); the grid is in
            # log-space, so with the log-Jacobians sigma, nu
            lp = logZ - 50.0 * sig + torch.log(sig) - 0.1 * nu + torch.log(nu)
        return lp, s_hat, var_hat

    n_pts = int(flat_s.shape[0])
    if grid_batch is None or grid_batch >= n_pts:
        lp, s_hat, var_hat = run(flat_s, flat_n)
    else:
        parts = []
        for s0 in range(0, n_pts, grid_batch):
            e = min(s0 + grid_batch, n_pts)
            idx = torch.as_tensor(np.arange(grid_batch) % (e - s0) + s0, device=dev)
            parts.append([x[: e - s0] for x in run(flat_s[idx], flat_n[idx])])
        lp, s_hat, var_hat = (torch.cat(xs) for xs in zip(*parts))
    lp = lp.double().cpu().numpy()
    s_hat = s_hat.double().cpu().numpy()
    var_hat = var_hat.double().cpu().numpy()
    # extreme grid corners can blow the f32 Newton out of range: such
    # points get exactly zero weight and are zeroed out of the mixture
    bad = ~np.isfinite(lp)
    if bad.all():
        raise ValueError(
            f"sv_inla: the Laplace marginal is non-finite at ALL {lp.size} grid "
            "points — the grid is entirely outside the numerically representable "
            "region (masking would just return NaN again); widen/re-center "
            "sigma_grid/nu_grid")
    if bad.any():
        lp[bad] = -np.inf
        s_hat[bad] = 0.0
        var_hat[bad] = 0.0
    lp -= lp.max()
    w = np.exp(lp)
    w /= w.sum()

    sig_mean = float((w * sg.reshape(-1)).sum())
    sig_sd = float(np.sqrt((w * (sg.reshape(-1) - sig_mean) ** 2).sum()))
    nu_mean = float((w * ng.reshape(-1)).sum())
    nu_sd = float(np.sqrt((w * (ng.reshape(-1) - nu_mean) ** 2).sum()))
    path_mean = (w[:, None] * s_hat).sum(axis=0)
    path_var = (w[:, None] * (var_hat + (s_hat - path_mean) ** 2)).sum(axis=0)
    return {
        "sigma_grid": sigma_grid, "nu_grid": nu_grid,
        "posterior": w.reshape(sg.shape),
        "sigma_mean": sig_mean, "sigma_sd": sig_sd,
        "nu_mean": nu_mean, "nu_sd": nu_sd,
        "path_mean": path_mean, "path_sd": np.sqrt(path_var),
        "n_failed": int(bad.sum()),
    }
