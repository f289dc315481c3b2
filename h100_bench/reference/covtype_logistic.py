"""Plain reference of the covertype-sized logistic regression, in float64
on the given device, in blocks of rows and points.

The program's ``glm`` puts beta_j ~ Normal(0, 2.5 / sd(x_j)) (numpy's
population sd, a constant column taken as 1) and beta_0 ~ Normal(0, 2.5)
on unconstrained coefficients; the reference works those scales out
again from X. Its posterior moments come from importance sampling with
a Gaussian proposal at the Newton mode, with 1.1 times the inverse
Hessian as covariance.
"""

import math

import numpy as np
import torch

# the control: this reference with its products in TF32 (the port turns
# TF32 off) and the rest in float32
CONTROL = "tf32"

_ROWS = 1 << 16
_POINTS = 2048
_IS_DRAWS = 1 << 18
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _tf32(t):
    """Round float32 values to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the tensor cores read their inputs."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def unconstrain(trace, data, cfg):
    return {"beta": np.asarray(trace["beta"], np.float64),
            "beta_0": np.asarray(trace["beta_0"], np.float64)}


def prior_scales(x):
    sx = np.asarray(x, np.float64).std(axis=0)
    return 2.5 / np.where(sx > 1e-8, sx, 1.0), 2.5


def rounding_allowance(x, g, data, cfg, eps):
    """Nats by which the log-density can move when the reported draws
    ``x`` move by their rounding to the trace's precision (unit roundoff
    ``eps``): the coefficients are reported as sampled, so the sum of
    |d logp / d b| times 2 eps |b|."""
    total = np.abs(g["beta_0"]) * np.abs(np.asarray(x["beta_0"], np.float64))
    total = total + (np.abs(g["beta"]) * np.abs(np.asarray(x["beta"], np.float64))).sum(-1)
    return 2.0 * eps * total


class _Data:
    def __init__(self, data, device, dtype):
        self.x = torch.as_tensor(data["X"], device=device).to(dtype)
        self.y = torch.as_tensor(data["y"], device=device).to(dtype)
        s, s0 = prior_scales(data["X"])
        self.s = torch.as_tensor(s, device=device, dtype=dtype)
        self.s0 = s0


def _block_logp_grad(d, beta, b0, tf32, grad=True):
    """logp (m,), d logp / d beta (m, D), d logp / d beta_0 (m,) of m
    points (the gradients None where ``grad`` is False)."""
    m = beta.shape[0]
    lp = torch.zeros(m, dtype=beta.dtype, device=beta.device)
    gb = torch.zeros_like(beta)
    g0 = torch.zeros_like(b0)
    bt = _tf32(beta.T.contiguous()) if tf32 else beta.T
    for r in range(0, d.x.shape[0], _ROWS):
        x, y = d.x[r:r + _ROWS], d.y[r:r + _ROWS, None]
        eta = (_tf32(x) if tf32 else x) @ bt + b0
        lp += (y * eta - torch.nn.functional.softplus(eta, threshold=30.0)).sum(0)
        if grad:
            res = y - torch.sigmoid(eta)
            gb += ((_tf32(res.T.contiguous()) @ _tf32(x)) if tf32 else res.T @ x)
            g0 += res.sum(0)
    lp += (-0.5 * (beta / d.s) ** 2).sum(1) - torch.log(d.s).sum() - beta.shape[1] * _HALF_LOG_2PI
    lp += -0.5 * (b0 / d.s0) ** 2 - math.log(d.s0) - _HALF_LOG_2PI
    if not grad:
        return lp, None, None
    return lp, gb - beta / d.s**2, g0 - b0 / d.s0**2


def logp_and_grad(u, data, cfg, precision="float64", device=None):
    """Log-density of the points ``u`` ({"beta": (n, D), "beta_0": (n,)})
    and its gradient, float64 numpy, computed in ``precision`` ("float64",
    or "tf32": products in TF32, the rest in float32)."""
    tf32 = precision == "tf32"
    dt = torch.float32 if tf32 else torch.float64
    d = _Data(data, device, dt)
    beta = torch.as_tensor(np.asarray(u["beta"]), device=device).to(dt)
    b0 = torch.as_tensor(np.asarray(u["beta_0"]), device=device).to(dt)
    out = [_block_logp_grad(d, beta[i:i + _POINTS], b0[i:i + _POINTS], tf32)
           for i in range(0, beta.shape[0], _POINTS)]
    lp, gb, g0 = (torch.cat(parts).double().cpu().numpy() for parts in zip(*out))
    return lp, {"beta": gb, "beta_0": g0}


def _mode(d):
    """Newton's method on the log posterior from the origin; returns the
    mode (D + 1,) and the negative Hessian there."""
    p = d.x.shape[1]
    w = torch.zeros(p + 1, dtype=torch.float64, device=d.x.device)
    prec = torch.cat([1.0 / d.s**2, torch.tensor([1.0 / d.s0**2], dtype=torch.float64,
                                                  device=d.x.device)])
    for _ in range(50):
        g = -prec * w
        h = torch.diag(prec)
        for r in range(0, d.x.shape[0], _ROWS):
            x = d.x[r:r + _ROWS]
            xa = torch.cat([x, torch.ones_like(x[:, :1])], 1)
            pr = torch.sigmoid(xa @ w)
            g += xa.T @ (d.y[r:r + _ROWS] - pr)
            h += (xa * (pr * (1.0 - pr))[:, None]).T @ xa
        step = torch.linalg.solve(h, g)
        w = w + step
        if float(step.abs().max()) < 1e-12:
            break
    return w, h


def posterior(data, cfg, seed=0, device=None):
    """{"beta": (mean (D,), sd (D,), se (D,)), "beta_0": (mean, sd, se)}:
    importance sampling from a Gaussian at the mode, seeded by ``seed``;
    ``se`` is the standard error of the self-normalised estimate of the
    mean."""
    d = _Data(data, device, torch.float64)
    w, h = _mode(d)
    chol = torch.linalg.cholesky(torch.linalg.inv(h) * 1.1)
    gen = torch.Generator(device=d.x.device)
    gen.manual_seed(int(seed) + 1)
    eps = torch.randn(_IS_DRAWS, w.shape[0], generator=gen, dtype=torch.float64,
                      device=d.x.device)
    pts = w + eps @ chol.T
    lq = -0.5 * (eps**2).sum(1)
    lp = torch.cat([_block_logp_grad(d, pts[i:i + _POINTS, :-1], pts[i:i + _POINTS, -1],
                                     False, grad=False)[0]
                    for i in range(0, _IS_DRAWS, _POINTS)])
    lw = lp - lq
    wt = torch.exp(lw - lw.max())
    wt = wt / wt.sum()
    mean = (wt[:, None] * pts).sum(0)
    sd = torch.sqrt((wt[:, None] * (pts - mean) ** 2).sum(0))
    se = torch.sqrt((wt[:, None] ** 2 * (pts - mean) ** 2).sum(0))
    mean, sd, se = (t.cpu().numpy() for t in (mean, sd, se))
    return {"beta": (mean[:-1], sd[:-1], se[:-1]), "beta_0": (mean[-1], sd[-1], se[-1])}
