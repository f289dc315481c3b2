"""Gaussian-process model building on the IR (``exmc_tpu/gp.py``).

Two formulations, both plain IR graphs:

* ``gp_marginal``: Gaussian-noise regression with f marginalized
  analytically, y ~ MvNormal(mean, K(X, X; theta) + sigma^2 I); only the
  kernel hyperparameters are sampled. Its covariance is a sampled
  matrix, so the compiled model runs eagerly on the card, not from a
  CUDA graph (ROADMAP §3).
* ``gp_latent``: non-Gaussian likelihoods, WHITENED: z ~ N(0, I),
  f = m + L(theta) z with L the jittered Cholesky, applied one point at
  a time like every det callable (``torch.func.vmap``).

``gp_predict`` draws f* | f, theta at new inputs from the exact
conditional N(Ks^T K^-1 f, Kss - Ks^T K^-1 Ks), one draw per posterior
sample, from a ``torch.Generator`` or from injected standard normals.

Kernels are pairwise torch functions with scalar or per-dimension (ARD)
lengthscales; X is (n,) or (n, p). A kernel's inputs may be numpy
arrays or tensors; it computes on the device and in the dtype of its
first tensor argument, else in ``default_dtype()`` on ``"cuda"``.
"""

import math

import numpy as np
import torch

from exmc_tpu_torch.config import default_dtype, prepare_device
from exmc_tpu_torch.math import cholesky_or_nan, const_like

__all__ = [
    "rbf", "matern32", "matern52", "periodic", "linear",
    "gp_latent", "gp_marginal", "gp_predict", "KERNELS",
]


def _like(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x
    return torch.zeros((), dtype=default_dtype(), device=prepare_device(None))


def _t(x, like):
    """A tensor stays, a Python number stays (it broadcasts), an array
    becomes a tensor like ``like``."""
    if isinstance(x, (torch.Tensor, int, float)):
        return x
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def _as_2d(x, like):
    x = _t(x, like)
    return x[:, None] if x.ndim == 1 else x


def _sqdist(x1, x2, lengthscale):
    """Pairwise scaled squared distances, (n1, n2). ``lengthscale`` is
    scalar or (p,) (ARD)."""
    like = _like(x1, x2, lengthscale)
    ls = _t(lengthscale, like)
    a = _as_2d(x1, like) / ls
    b = _as_2d(x2, like) / ls
    d = a[:, None, :] - b[None, :, :]
    return torch.sum(d * d, dim=-1)


def rbf(x1, x2, lengthscale=1.0, variance=1.0):
    """Squared-exponential kernel."""
    return variance * torch.exp(-0.5 * _sqdist(x1, x2, lengthscale))


def matern32(x1, x2, lengthscale=1.0, variance=1.0):
    r = torch.sqrt(_sqdist(x1, x2, lengthscale) + 1e-12)
    a = math.sqrt(3.0) * r
    return variance * (1.0 + a) * torch.exp(-a)


def matern52(x1, x2, lengthscale=1.0, variance=1.0):
    r = torch.sqrt(_sqdist(x1, x2, lengthscale) + 1e-12)
    a = math.sqrt(5.0) * r
    return variance * (1.0 + a + a * a / 3.0) * torch.exp(-a)


def periodic(x1, x2, lengthscale=1.0, variance=1.0, period=1.0):
    """Exp-sine-squared kernel (1-d inputs or summed over dims)."""
    like = _like(x1, x2, lengthscale, variance, period)
    d = _as_2d(x1, like)[:, None, :] - _as_2d(x2, like)[None, :, :]
    s = torch.sin(math.pi * d / period) / lengthscale
    return variance * torch.exp(-2.0 * torch.sum(s * s, dim=-1))


def linear(x1, x2, variance=1.0, offset=0.0):
    like = _like(x1, x2, variance, offset)
    a = _as_2d(x1, like) - offset
    b = _as_2d(x2, like) - offset
    return variance * (a @ b.T)


KERNELS = {"rbf": rbf, "matern32": matern32, "matern52": matern52,
           "periodic": periodic, "linear": linear}


def _kernel_fn(kernel):
    if callable(kernel):
        return kernel
    if kernel not in KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r} (one of {sorted(KERNELS)} "
            "or a callable (x1, x2, **hypers) -> matrix)")
    return KERNELS[kernel]


def _split_hypers(hypers):
    """{name: ref-or-constant} -> ([(kw name, node ref)...] in fixed
    order, constants). Ref VALUES become det-node dependencies (the kw
    name is how the kernel consumes them); constants close over."""
    refs, consts = [], {}
    for k, v in sorted(hypers.items()):
        if isinstance(v, str):
            refs.append((k, v))
        else:
            consts[k] = v
    return refs, consts


def _cov_builder(kernel, X, hypers, jitter):
    """Det-node fn computing K(X, X) + jitter I from one point's sampled
    hyper values. Returns (fn, [node refs] for the det args)."""
    kfn = _kernel_fn(kernel)
    refs, consts = _split_hypers(hypers)
    x_of = const_like(np.asarray(X, np.float64))
    # array constants (ARD lengthscales) reach the device once, like X
    arrays = {k: const_like(np.asarray(v, np.float64)) for k, v in consts.items()
              if np.ndim(v)}
    scalars = {k: float(v) for k, v in consts.items() if not np.ndim(v)}

    def build(*vals):
        like = _like(*vals)
        x = x_of(like)
        kw = dict(scalars)
        kw.update({k: get(like) for k, get in arrays.items()})
        kw.update({name: v for (name, _), v in zip(refs, vals)})
        k = kfn(x, x, **kw)
        if jitter:
            k = k + jitter * torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
        return k

    return build, [r for (_, r) in refs]


def gp_latent(m, name, X, *, kernel="rbf", mean=0.0, jitter=1e-4, **hypers):
    """Add a whitened latent GP to Model ``m``: ``{name}_z`` ~ N(0, I),
    ``{name}`` = mean + chol(K + jitter I) z. Returns the f node id.

    ``hypers`` (lengthscale=, variance=, ...) may be node references
    (strings) or constants; referenced hyperparameters rebuild the
    kernel matrix inside the compiled logp, so NUTS sees their exact
    gradients through the Cholesky. The default jitter is 1e-4: the
    Cholesky's gradient flows into NUTS, and in f32 a near-singular K
    explodes it. For classification pass the latent straight into
    ``dists.Bernoulli {"logits": f}``."""
    from exmc_tpu_torch import dists

    X = np.asarray(X)
    n = X.shape[0]
    build, refs = _cov_builder(kernel, X, hypers, jitter)
    m.rv(f"{name}_z", dists.Normal, {"mu": np.zeros(n), "sigma": 1.0}, shape=(n,))
    m.det(f"{name}_cov", build, refs)

    def whiten(cov, z):
        return mean + cholesky_or_nan(cov) @ z

    m.det(name, whiten, [f"{name}_cov", f"{name}_z"])
    return name


def gp_marginal(m, name, X, y_obs, *, kernel="rbf", mean=0.0, noise="noise",
                jitter=1e-6, **hypers):
    """Add a marginalized GP REGRESSION observation to Model ``m``:
    y ~ MvNormal(mean, K(X, X) + noise^2 I + jitter I), observed at
    ``y_obs``. ``noise`` is a node reference (sampled noise sd) or a
    constant. Returns the obs node id ``{name}_obs``."""
    from exmc_tpu_torch import dists

    X = np.asarray(X)
    y_obs = np.asarray(y_obs)
    n = X.shape[0]
    build, refs = _cov_builder(kernel, X, hypers, jitter)
    m.det(f"{name}_kern", build, refs)
    if isinstance(noise, str):
        def full_cov(k, s):
            return k + (s * s) * torch.eye(n, dtype=k.dtype, device=k.device)

        m.det(f"{name}_cov", full_cov, [f"{name}_kern", noise])
    else:
        def full_cov_c(k):
            return k + float(noise) ** 2 * torch.eye(n, dtype=k.dtype, device=k.device)

        m.det(f"{name}_cov", full_cov_c, [f"{name}_kern"])
    m.rv(name, dists.MvNormal, {"mu": mean * np.ones(n), "cov": f"{name}_cov"})
    m.obs(f"{name}_obs", name, y_obs)
    return f"{name}_obs"


def gp_predict(trace, X, Xstar, *, kernel="rbf", mean=0.0, jitter=1e-4,
               f_name=None, y=None, noise=None, seed=0, num_draws=None,
               eps=None, device=None, **hypers):
    """Posterior GP draws at new inputs ``Xstar``, one per posterior
    sample, computed on ``device`` (default ``"cuda"``); returns an
    (S, n*) numpy array.

    Latent form: pass ``f_name``; it conditions on the sampled latent f
    (trace[f_name + "_z"] is whitened back through each draw's kernel).
    Marginal form: pass ``y`` (and ``noise``: a trace key or a
    constant); it conditions on the observations through K + sigma^2 I.

    ``hypers`` values that are strings are looked up in the trace;
    others are constants. ``jitter`` must match the model's (the
    default matches gp_latent's 1e-4). The conditional draws' standard
    normals come from a generator seeded with ``seed``, or from ``eps``
    (S, n*) when given."""
    if (f_name is None) == (y is None):
        raise ValueError("pass exactly one of f_name= (latent) or y= (marginal)")
    kfn = _kernel_fn(kernel)
    dev = prepare_device(device)
    dtype = default_dtype()
    X = np.asarray(X)
    Xstar = np.asarray(Xstar)
    n, ns = X.shape[0], Xstar.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def flatten(a):
        a = np.asarray(a)
        return a.reshape(-1, *a.shape[2:]) if a.ndim > 2 else a.reshape(-1)

    refs, consts = _split_hypers(hypers)
    hyper_draws = {name: t(flatten(trace[ref])) for name, ref in refs}
    if f_name is not None:
        extra = t(flatten(trace[f_name + "_z"]))
        s_total = extra.shape[0]
    else:
        y_t = t(y)
        if isinstance(noise, str):
            extra = t(flatten(trace[noise]))
            s_total = extra.shape[0]
        else:
            if not hyper_draws:
                raise ValueError("marginal gp_predict needs at least one "
                                 "trace-ref hyper or noise")
            s_total = next(iter(hyper_draws.values())).shape[0]
            extra = torch.full((s_total,), float(noise or 0.0), dtype=dtype, device=dev)

    if num_draws is not None and num_draws < s_total:
        idx = torch.as_tensor(np.linspace(0, s_total - 1, num_draws).astype(int),
                              device=dev)
        hyper_draws = {k: v[idx] for k, v in hyper_draws.items()}
        extra = extra[idx]
        s_total = num_draws

    if eps is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        eps = torch.randn(s_total, ns, generator=gen, dtype=dtype, device=dev)
    else:
        eps = t(eps)
    xt, xst = t(X), t(Xstar)
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_s = torch.eye(ns, dtype=dtype, device=dev)

    def one(hv, ex, e):
        kw = dict(consts)
        kw.update(hv)
        kxx = kfn(xt, xt, **kw) + jitter * eye_n
        kxs = kfn(xt, xst, **kw)
        kss = kfn(xst, xst, **kw) + jitter * eye_s
        if f_name is not None:
            rhs = cholesky_or_nan(kxx) @ ex      # whiten z -> f - mean
            kc = kxx
        else:
            kc = kxx + (ex * ex) * eye_n
            rhs = y_t - mean
        lc = cholesky_or_nan(kc)
        alpha = torch.cholesky_solve(rhs[:, None], lc)[:, 0]
        mu_s = mean + kxs.T @ alpha
        v = torch.linalg.solve_triangular(lc, kxs, upper=False)
        cov_s = kss - v.T @ v
        # the subtraction can dip ~1e-5 below PSD in f32 when the draw's
        # lengthscale makes K(X, X) near-singular: a stabilizer scaled
        # with the covariance's magnitude
        stab = 1e-5 * (1.0 + torch.max(torch.diagonal(kss)))
        ls = cholesky_or_nan(cov_s + stab * eye_s)
        return mu_s + ls @ e

    draws = torch.func.vmap(one)(hyper_draws, extra, eps)
    return draws.cpu().numpy()
