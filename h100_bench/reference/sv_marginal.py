"""Plain reference of the Laplace-marginal stochastic-volatility model, in
plain PyTorch and NumPy, in float64 (``CONTROL``, the precision below it:
float32), on the card or the CPU.

The model is NumPyro's stochastic-volatility example (after Hoffman and
Gelman 2014, JMLR 15, sec. 4):

    sigma ~ Exponential(50),  s ~ GaussianRandomWalk(sigma) over T steps,
    nu ~ Exponential(0.1),    r_t ~ StudentT(nu, 0, exp(s_t)).

Its departures from NumPyro's full-path model, each part of the
configuration that the cell runs:

- the latent path is integrated out by a Laplace approximation at the
  mode of g(s) = -1/2 s'Qs + sum_t loglik_t(s_t) (INLA within MCMC):
  log p(r | sigma, nu) ~= g(s_hat) + 1/2 log|Q| - 1/2 log|Q + W|, with W
  the diagonal of -loglik'' at the mode, and the sampler draws (sigma,
  nu) alone;
- W is floored at ``W_FLOOR`` = 1e-3 (the Student-t's curvature falls to
  0 in its tails), and every Newton iterate is clamped to |s| <= 40;
- the random walk starts at s_1 ~ N(0, sigma), NumPyro's convention, so
  Q = D'D / sigma^2 with D the first-difference matrix and log|Q| = -2 T
  log sigma;
- the returns are synthetic, drawn from the seed by the configuration's
  ``build``, not NumPyro's S&P 500 series.

This file shares no code with the port's ``marginal.py``: it factors
Q + W by the sequential LDL' (Thomas) recursion over time, vectorised
over points (time-major arrays, (T, n)); it runs Newton to convergence
(the scaled residual max|l1 - Q s| / (1 + max|l1|) below 5000 eps,
1.1e-12 in float64), not a fixed count; and it takes the gradient by
reverse-mode autograd through ``UNROLL`` further full Newton steps taken
from the converged mode, which is held as a constant, in (log sigma,
log nu). From a fixed point each step contracts the error of the mode's
derivative by (Q + W)^-1 (W - W_true), which is 0 wherever the floor
does not bind, so the unrolled derivative reaches the exact one within
rounding in a few steps (at T = 1000, three steps agree with sixteen to
5e-12 relative, and with central differences in float64 to 3e-9). The port differentiates through the mode by
the implicit-function theorem, one solve at the mode; the unrolled steps
are a separate route to the same derivative. The route holds in either
precision: the float32 control (``CONTROL``) reads the gradient of a
float32 marginal, where central differences of a logZ of ~1e4 nats
would read their own rounding (~0.1 at float32's best step).
"""

import math

import numpy as np
import torch

# the control: this reference in the precision below the configuration's
CONTROL = "float32"

W_FLOOR = 1e-3
S_CLAMP = 40.0
SIGMA_RATE, NU_RATE = 50.0, 0.1
_DTYPES = {"float64": torch.float64, "float32": torch.float32}
_MAX_ITERS = 100
_MAX_HALVINGS = 30
# full Newton steps differentiated from the converged mode
UNROLL = 3


def _tol(dt):
    """Newton's tolerance on the scaled residual: 1.1e-12 in float64."""
    return 5000.0 * torch.finfo(dt).eps


def unconstrain(trace, data, cfg):
    """{name: (...) constrained} -> {name: (...) unconstrained}: the
    program samples log sigma and log nu."""
    return {k: np.log(np.asarray(trace[k], np.float64)) for k in ("sigma", "nu")}


def _device(device):
    return torch.device("cpu" if device is None else device)


class _Points:
    """n points (sigma, nu) of one dtype, with the returns, time-major."""

    def __init__(self, r, sigma, nu, dt, device):
        r = torch.as_tensor(np.asarray(r, np.float64), device=device)
        self.r2 = (r * r).to(dt)[:, None]                            # (T, 1)
        self.T = self.r2.shape[0]

        def points(x):
            if isinstance(x, torch.Tensor):
                return x
            return torch.as_tensor(np.asarray(x, np.float64), device=device).to(dt)

        sigma, nu = points(sigma), points(nu)
        self.sigma, self.nu = sigma, nu
        self.inv_s2 = 1.0 / (sigma * sigma)
        self.const = (torch.lgamma(0.5 * (nu + 1.0)) - torch.lgamma(0.5 * nu)
                      - 0.5 * torch.log(nu * math.pi))

    def take(self, idx):
        """The points ``idx``."""
        out = object.__new__(_Points)
        out.r2, out.T = self.r2, self.T
        out.sigma, out.nu = self.sigma[idx], self.nu[idx]
        out.inv_s2, out.const = self.inv_s2[idx], self.const[idx]
        return out

    def zeros(self):
        return self.r2.new_zeros(self.T, len(self.sigma))

    def g(self, s):
        """g(s) = -1/2 s'Qs + sum_t loglik_t(s_t): (n,). s'Qs = (s_1^2 +
        sum (s_t - s_{t-1})^2) / sigma^2."""
        d = torch.diff(s, dim=0)
        quad = (s[0] * s[0] + (d * d).sum(0)) * self.inv_s2
        u = self.r2 * torch.exp(-2.0 * s) / self.nu
        ll = (self.const - s - 0.5 * (self.nu + 1.0) * torch.log1p(u)).sum(0)
        return ll - 0.5 * quad

    def derivs(self, s):
        """The Student-t log-density's first and second derivatives in s,
        elementwise: (T, n) each."""
        u = self.r2 * torch.exp(-2.0 * s) / self.nu
        frac = u / (1.0 + u)
        return (self.nu + 1.0) * frac - 1.0, -2.0 * (self.nu + 1.0) * frac / (1.0 + u)

    def q_diag(self):
        """Q's diagonal, (2, ..., 2, 1) / sigma^2: (T, n); its off-diagonal
        is -1 / sigma^2."""
        d = torch.full((self.T, 1), 2.0, dtype=self.r2.dtype, device=self.r2.device)
        d[-1] = 1.0
        return d * self.inv_s2

    def qs(self, s):
        """Q s."""
        out = 2.0 * s
        out[-1] = s[-1]
        out[:-1] -= s[1:]
        out[1:] -= s[:-1]
        return out * self.inv_s2


def _ldl(a, b2):
    """The D of the LDL' of the tridiagonal with diagonal ``a`` (T, n) and
    off-diagonal b with b^2 = ``b2`` (n,): d_1 = a_1, d_t = a_t - b^2 /
    d_{t-1}, one time step after another (differentiable)."""
    a = a.unbind(0)
    d = [a[0]]
    for t in range(1, len(a)):
        d.append(torch.addcdiv(a[t], b2, d[-1], value=-1.0))
    return torch.stack(d)


def _solve(d, b, rhs):
    """x with (L D L') x = rhs, L's sub-diagonal b / d_{t-1}: forward, then
    back, one time step after another (differentiable)."""
    ell = (b / d[:-1]).unbind(0)                # T-1 of (n,)
    rhs = rhs.unbind(0)
    y = [rhs[0]]
    for t in range(1, len(rhs)):
        y.append(torch.addcmul(rhs[t], ell[t - 1], y[-1], value=-1.0))
    z = (torch.stack(y) / d).unbind(0)
    x = [z[-1]]
    for t in range(len(z) - 2, -1, -1):
        x.append(torch.addcmul(z[t], ell[t], x[-1], value=-1.0))
    return torch.stack(x[::-1])


def _newton_step(p, s, g_cur, l1, l2):
    """One damped Newton step of the points ``p`` from ``s``, where the
    log-likelihood's derivatives are ``l1``, ``l2``: solve (Q + W) s' = W s
    + l1, halve the step until g does not fall (beyond rounding), clamp.
    Returns (s', g(s'))."""
    w = torch.clamp_min(-l2, W_FLOOR)
    step = _solve(_ldl(p.q_diag() + w, p.inv_s2 * p.inv_s2), -p.inv_s2, w * s + l1) - s
    new, g_new = s.clone(), g_cur.clone()
    alpha = torch.ones_like(g_cur)
    todo = torch.arange(s.shape[1], device=s.device)
    slack = 1e-9 * (g_cur.abs() + 1.0)
    for _ in range(_MAX_HALVINGS):
        cand = torch.clamp(s[:, todo] + alpha[todo] * step[:, todo], -S_CLAMP, S_CLAMP)
        gc = p.take(todo).g(cand)
        ok = torch.isfinite(gc) & (gc >= g_cur[todo] - slack[todo])
        new[:, todo[ok]] = cand[:, ok]
        g_new[todo[ok]] = gc[ok]
        todo = todo[~ok]
        if not len(todo):
            break
        alpha[todo] *= 0.5
    return new, g_new


def _mode(p, s):
    """Newton from ``s`` (T, n) to the mode. A point stops once its scaled
    residual max|l1 - Q s| / (1 + max|l1|) is under the tolerance, or
    once a step no longer moves it (max|ds| <= 5000 eps (1 + max|s|): at
    small sigma, rounding in Q s holds the residual up), or after
    ``_MAX_ITERS`` steps."""
    s = s.clone()
    tol = _tol(s.dtype)
    live = torch.arange(s.shape[1], device=s.device)
    g_cur = p.g(s)
    for _ in range(_MAX_ITERS):
        cur = s[:, live]
        l1, l2 = p.take(live).derivs(cur)
        keep = (l1 - p.take(live).qs(cur)).abs().amax(0) >= tol * (1.0 + l1.abs().amax(0))
        live, cur, l1, l2 = live[keep], cur[:, keep], l1[:, keep], l2[:, keep]
        if not len(live):
            break
        new, g_new = _newton_step(p.take(live), cur, g_cur[live], l1, l2)
        s[:, live] = new
        g_cur[live] = g_new
        live = live[(new - cur).abs().amax(0) > tol * (1.0 + cur.abs().amax(0))]
        if not len(live):
            break
    return s


def _log_z_at(p, s):
    """logZ (n,) of the points ``p`` with the mode ``s``."""
    _, l2 = p.derivs(s)
    d = _ldl(p.q_diag() + torch.clamp_min(-l2, W_FLOOR), p.inv_s2 * p.inv_s2)
    # 1/2 log|Q| = -T log sigma; log|Q + W| = sum log d
    return p.g(s) - p.T * torch.log(p.sigma) - 0.5 * torch.log(d).sum(0)


def _log_z(p, s0=None):
    """(logZ (n,), the mode (T, n)) of the points ``p``, Newton from
    ``s0`` (default 0)."""
    with torch.no_grad():
        s = _mode(p, p.zeros() if s0 is None else s0)
        return _log_z_at(p, s), s


def _log_z_and_grad(r, ls, ln, dt, device):
    """logZ (n,) at the points (log sigma, log nu) = (``ls``, ``ln``) in
    ``dt``, and its gradient in them ((n,) each): Newton to the mode
    without a graph, then ``UNROLL`` full Newton steps from it, and logZ
    there, under autograd."""
    ls, ln = (torch.as_tensor(np.asarray(x, np.float64), device=device).to(dt)
              for x in (ls, ln))
    with torch.no_grad():
        p = _Points(r, torch.exp(ls), torch.exp(ln), dt, device)
        s = _mode(p, p.zeros())
    with torch.enable_grad():
        ls, ln = ls.requires_grad_(True), ln.requires_grad_(True)
        p = _Points(r, torch.exp(ls), torch.exp(ln), dt, device)
        for _ in range(UNROLL):
            l1, l2 = p.derivs(s)
            w = torch.clamp_min(-l2, W_FLOOR)
            s = torch.clamp(_solve(_ldl(p.q_diag() + w, p.inv_s2 * p.inv_s2), -p.inv_s2,
                                   w * s + l1), -S_CLAMP, S_CLAMP)
        log_z = _log_z_at(p, s)
        g_ls, g_ln = torch.autograd.grad(log_z.sum(), [ls, ln])
    return log_z.detach(), g_ls, g_ln


def _prior(ls, ln):
    """Log-density of the priors in (log sigma, log nu), Jacobians
    included, and its gradient (float64 numpy)."""
    sigma, nu = np.exp(ls), np.exp(ln)
    lp = (math.log(SIGMA_RATE) - SIGMA_RATE * sigma + ls
          + math.log(NU_RATE) - NU_RATE * nu + ln)
    return lp, 1.0 - SIGMA_RATE * sigma, 1.0 - NU_RATE * nu


def logp_and_grad(u, data, cfg, precision="float64", device=None):
    """Log-density of the unconstrained points ``u`` ({"sigma", "nu"}: (n,)
    logs) and its gradient, both float64 numpy, computed in ``precision``
    on ``device`` (default the CPU); logZ's gradient through the unrolled
    Newton steps (module docstring)."""
    dt, dev = _DTYPES[precision], _device(device)
    ls = np.asarray(u["sigma"], np.float64)
    ln = np.asarray(u["nu"], np.float64)
    lz, d_ls, d_ln = _log_z_and_grad(data["r"], ls, ln, dt, dev)
    lp0, g_ls, g_ln = _prior(ls, ln)
    lp = lz.double().cpu().numpy() + lp0
    return lp, {"sigma": g_ls + d_ls.double().cpu().numpy(),
                "nu": g_ln + d_ln.double().cpu().numpy()}


def rounding_allowance(x, g, data, cfg, eps):
    """Nats by which the log-density can move when the reported draws
    ``x`` move by their rounding to the trace's precision (unit roundoff
    ``eps``): sigma and nu are reported as sampled, so log sigma and log
    nu move by eps each, and the first-order change is (|g_sigma| +
    |g_nu|) eps, doubled for safety. ``g`` is the gradient in the sampled
    coordinates."""
    return 2.0 * eps * (np.abs(g["sigma"]) + np.abs(g["nu"]))


def _grid_moments(r, ls, ln, device):
    """The posterior's weights on the grid ``ls`` x ``ln`` (log sigma, log
    nu), and the means and sds of sigma and nu by the midpoint rule;
    also their values from every other grid line (the grid's error)."""
    a, b = np.meshgrid(ls, ln, indexing="ij")
    lz, _ = _log_z(_Points(r, np.exp(a.ravel()), np.exp(b.ravel()), torch.float64, device))
    lw = (lz.cpu().numpy() + _prior(a.ravel(), b.ravel())[0]).reshape(a.shape)
    lw = np.where(np.isfinite(lw), lw, -np.inf)

    def moments(sl):
        w = np.exp(lw[sl] - lw[sl].max())
        w /= w.sum()
        out = {}
        for name, v in (("sigma", np.exp(a[sl])), ("nu", np.exp(b[sl]))):
            mean = float((w * v).sum())
            out[name] = (mean, math.sqrt(max(float((w * v * v).sum()) - mean * mean, 0.0)))
        return out, w

    fine, w = moments((slice(None), slice(None)))
    half, _ = moments((slice(None, None, 2), slice(None, None, 2)))
    return fine, half, w, lw


def posterior(data, cfg, seed=0, device=None):
    """{name: (mean, sd, se)} of sigma and nu by quadrature on a grid of
    (log sigma, log nu), the priors and Jacobians included, in float64 on
    ``device`` (default the CPU): a coarse
    grid finds the mass, a second one centres on it, and the third spans
    the mean +- 8 sd of each coordinate at 32 lines a side; ``se`` is the
    difference between that grid's moments and those of every other of
    its lines."""
    r, dev = np.asarray(data["r"], np.float64), _device(device)
    ls = np.linspace(math.log(3e-3), math.log(0.3), 16)
    ln = np.linspace(math.log(1.0), math.log(100.0), 16)
    for n in (16, 32):
        _, _, w, lw = _grid_moments(r, ls, ln, dev)
        a, b = np.meshgrid(ls, ln, indexing="ij")
        m_a, m_b = (w * a).sum(), (w * b).sum()
        sd_a = math.sqrt(max((w * (a - m_a) ** 2).sum(), 0.0))
        sd_b = math.sqrt(max((w * (b - m_b) ** 2).sum(), 0.0))
        # at least the coarse grid's spacing, so that one point of mass
        # gives a span
        sd_a = max(sd_a, (ls[1] - ls[0]) / 2.0)
        sd_b = max(sd_b, (ln[1] - ln[0]) / 2.0)
        ls = np.linspace(m_a - 8.0 * sd_a, m_a + 8.0 * sd_a, n)
        ln = np.linspace(m_b - 8.0 * sd_b, m_b + 8.0 * sd_b, n)
    fine, half, _, _ = _grid_moments(r, ls, ln, dev)
    return {k: (np.asarray(fine[k][0]), np.asarray(fine[k][1]),
                np.asarray(abs(fine[k][0] - half[k][0])))
            for k in ("sigma", "nu")}
