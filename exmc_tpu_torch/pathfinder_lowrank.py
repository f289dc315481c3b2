"""Low-rank-plus-diagonal Pathfinder covariance
(``exmc_tpu/pathfinder_lowrank.py``; Zhang, Carpenter, Gelman & Vehtari
2022), batched over any leading axes (the JAX package vmaps it over the
path's points).

At an L-BFGS iterate with curvature pairs S, Y (m, d) (gradients of the
negative log-density), the inverse-Hessian estimate is

    Sigma = diag(alpha) + B G B^T,   B = [diag(alpha) Y, S]  (d x 2m)

with R = upper-tri(S^T Y), E = diag(S^T Y) and G's blocks below.
Sampling and the exact log-determinant use the thin QR of
diag(alpha)^{-1/2} B = Q Rq and L = chol(I + Rq G Rq^T):

    log|Sigma| = sum(log alpha) + 2 log|det L|
    x = mu + a^{1/2} (Q (L - I) Q^T + I) u,   u ~ N(0, I_d)

Invalid history slots are masked by identity rows so R stays invertible.
QR's column signs are the library's choice and may differ from XLA's;
Q (L - I) Q^T, the log-determinant and the draws do not depend on them.
A Cholesky factor that does not exist is NaN, as ``jnp.linalg.cholesky``
gives it.
"""

import math

import torch


def lowrank_factors(alpha, s_hist, y_hist, valid):
    """(Q (..., d, k), L (..., k, k), log_det_sigma (...)) from a diagonal
    alpha (..., d) and history buffers (..., m, d) with a validity mask
    (..., m); k = min(d, 2m)."""
    m = s_hist.shape[-2]
    dt, dev = alpha.dtype, alpha.device
    vmask = valid.to(dt)
    s = s_hist * vmask.unsqueeze(-1)
    y = y_hist * vmask.unsqueeze(-1)

    sty = s @ y.transpose(-1, -2)                      # (..., m, m)
    eye_m = torch.eye(m, dtype=dt, device=dev)
    mask2 = vmask.unsqueeze(-1) * vmask.unsqueeze(-2)
    r = torch.triu(sty) * mask2 + torch.diag_embed(1.0 - vmask)
    e = torch.diag_embed(torch.diagonal(sty, dim1=-2, dim2=-1) * vmask + (1.0 - vmask))

    ay = y * alpha.unsqueeze(-2)                       # (..., m, d)
    b = torch.cat([ay, s], dim=-2)                     # (..., 2m, d) = B^T
    ytay = y @ ay.transpose(-1, -2)
    r_inv = torch.linalg.solve_triangular(r, eye_m.expand_as(r), upper=True)
    r_inv_t = r_inv.transpose(-1, -2)
    g = torch.cat([
        torch.cat([torch.zeros_like(r_inv), -r_inv], dim=-1),
        torch.cat([-r_inv_t, r_inv_t @ (e + ytay) @ r_inv], dim=-1),
    ], dim=-2)                                         # (..., 2m, 2m)

    w = (b * torch.rsqrt(alpha).unsqueeze(-2)).transpose(-1, -2)  # (..., d, 2m)
    q, rq = torch.linalg.qr(w, mode="reduced")
    k = rq.shape[-2]
    eye_k = torch.eye(k, dtype=dt, device=dev)
    inner = eye_k + rq @ g @ rq.transpose(-1, -2)
    inner = 0.5 * (inner + inner.transpose(-1, -2))
    lchol, info = torch.linalg.cholesky_ex(inner + 1e-8 * eye_k)
    bad = (info != 0).reshape(info.shape + (1, 1))
    lchol = torch.where(bad, torch.full_like(lchol, math.nan), lchol)
    log_det = torch.sum(torch.log(alpha), dim=-1) + 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(lchol, dim1=-2, dim2=-1))), dim=-1)
    return q, lchol, log_det


def sample_and_logq(u, mu, alpha, q, lchol, log_det):
    """Draws x = mu + A u from N(mu, Sigma) for standard normals ``u``
    (..., n, d), and the exact log-density of each (..., n)."""
    d = mu.shape[-1]
    eye_k = torch.eye(lchol.shape[-1], dtype=mu.dtype, device=mu.device)
    qtu = u @ q                                        # (..., n, k)
    inner = qtu @ (lchol - eye_k).transpose(-1, -2)
    x = mu.unsqueeze(-2) + (u + inner @ q.transpose(-1, -2)) * torch.sqrt(alpha).unsqueeze(-2)
    # x - mu = A u with Sigma = A A^T, so the Mahalanobis form is |u|^2
    quad = torch.sum(u * u, dim=-1)
    logq = -0.5 * (d * math.log(2.0 * math.pi) + log_det.unsqueeze(-1) + quad)
    return x, logq


def marginal_sd(alpha, q, lchol):
    """sqrt(diag(Sigma)) = sqrt(alpha * (1 + rowsum(Q * (Q (L L^T - I)))))."""
    k = lchol.shape[-1]
    eye_k = torch.eye(k, dtype=alpha.dtype, device=alpha.device)
    mmat = q @ (lchol @ lchol.transpose(-1, -2) - eye_k)
    var = alpha * (1.0 + torch.sum(q * mmat, dim=-1))
    return torch.sqrt(torch.clamp_min(var, 1e-12))
