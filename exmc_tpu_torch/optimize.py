"""MAP estimation and the Laplace approximation (``exmc_tpu/optimize.py``).

- ``fit_map``: maximize the joint log-density with L-BFGS. The JAX
  package runs ``optax.lbfgs()`` with its defaults inside one
  ``lax.while_loop``; the port has its own L-BFGS with the same
  semantics (``_lbfgs_minimize``: memory 10, the scaled initial
  preconditioner, optax's zoom line search) as a loop on the host over
  0-d and (d,) tensors. Each iteration reads its stopping test on the
  host (one sync), and each line-search step one more. ``jacobian=False``
  is Stan's penalized-MLE objective (no change-of-variables terms).
- ``laplace``: draws from N(z_map, (-H)^-1), with H from the eager
  log-density's double backward (the value-and-grad the samplers use may
  be a CUDA graph replay, which has no second derivative), pushed
  through the constraint transforms.

Randomness: the random start is 0.1 * N(0, I) and the Laplace draws
N(0, I) from a CPU ``torch.Generator`` seeded from ``seed`` (the same
numbers on every device, so the deterministic fit starts where it does
on the CPU); ``noise=`` injects either, so that tests can feed in the
JAX package's draws.
"""

import math

import numpy as np
import torch

from exmc_tpu_torch import transforms as tf
from exmc_tpu_torch.compiler import CompiledModel, compile_logp
from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.nuts.masked import HostSyncs

# optax.lbfgs() defaults (optax 0.2.6): memory_size=10 and
# scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy="one") with its own defaults
MEMORY = 10
LS_MAX_STEPS = 20
LS_INCREASE = 2.0
LS_SLOPE_RTOL = 1e-4
LS_CURV_RTOL = 0.9
LS_APPROX_DEC_RTOL = 1e-6
LS_INTERVAL_THRESHOLD = 1e-5  # stepsize_precision
LADDER = (1e-6, 1e-4, 1e-2)


def _as_model(ir_or_model, ncp, device):
    if isinstance(ir_or_model, CompiledModel):
        return ir_or_model
    return compile_logp(ir_or_model, ncp=ncp, device=device)


def _run_data(model, data):
    """The ``data`` argument of the model's calls: None (its own data,
    captured) or a ``DeviceData``."""
    return None if data is None else model.device_data(data)


def _cpu_normals(seed, shape):
    """Standard normals from a CPU generator seeded with ``seed``: the
    same on every device, so a run on the card starts where the CPU's
    does."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=default_dtype())


def _jacobian_correction(pm):
    """(C, d) flat -> (C,) total log|det J| of the constraint transforms
    (the terms the compiler adds for free RVs; subtracting them gives
    Stan's jacobian=false objective)."""

    def total(flat):
        zmap = pm.unpack(flat)
        out = flat.new_zeros(flat.shape[:1])
        for e in pm.entries:
            out = out + tf.get(e.transform).log_abs_det_jacobian(zmap[e.id])
        return out

    return total


def _objective(model, ddata, jacobian):
    """(value_and_grad, value) of the objective over (C, d) batches:
    the model's log-density, less the Jacobian terms when
    ``jacobian=False``."""
    vag = model.value_and_grad
    if jacobian:
        return (lambda z: vag(z, ddata)), (lambda z: model.logp(z, ddata))
    corr = _jacobian_correction(model.pm)

    def c_vag(z):
        with torch.enable_grad():
            x = z.detach().requires_grad_(True)
            c = corr(x)
            if not c.requires_grad:  # no constraint transforms: a constant 0
                return c, torch.zeros_like(z)
            (g,) = torch.autograd.grad(c.sum(), x)
        return c.detach(), g

    def obj_vag(z):
        lp, g = vag(z, ddata)
        c, gc = c_vag(z)
        return lp - c, g - gc

    return obj_vag, (lambda z: model.logp(z, ddata) - corr(z))


# ---------------------------------------------------------------------------
# L-BFGS with optax's zoom line search
# ---------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    cc = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - cc * db
    v1 = fc - fa - cc * dc
    aa = (dc ** 2 * v0 + (-(db ** 2)) * v1) / denom
    bb = ((-(dc ** 3)) * v0 + db ** 3 * v1) / denom
    radical = bb * bb - 3.0 * aa * cc
    return a + (-bb + torch.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    bb = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * bb)


def _errors(stepsize, value, slope, value_init, slope_init):
    """optax's decrease error (with the approximate-Wolfe variant) and
    curvature error, NaN counted as +inf."""
    dec = value - value_init - LS_SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * LS_SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - LS_APPROX_DEC_RTOL * torch.abs(value_init)
    approx = torch.maximum(approx, delta_values)
    dec = torch.clamp_min(torch.minimum(approx, dec), 0.0)
    dec = torch.where(torch.isnan(dec), torch.full_like(dec, math.inf), dec)
    curv = torch.clamp_min(torch.abs(slope) - LS_CURV_RTOL * torch.abs(slope_init), 0.0)
    curv = torch.where(torch.isnan(curv), torch.full_like(curv, math.inf), curv)
    return dec, curv


def _zoom_linesearch(loss_vag, params, updates, value, grad, syncs):
    """optax's ``zoom_linesearch`` (tol 0, no maximal stepsize, initial
    guess 1) along ``updates`` from ``params``. Returns (stepsize, value,
    grad) at the accepted point; one host sync per step."""
    zero = value.new_zeros(())
    slope = _dot(updates, grad)
    s = dict(stepsize=zero, value=value, grad=grad, slope=slope,
             decrease_error=zero + math.inf, low=zero, value_low=value,
             slope_low=slope, high=zero, value_high=value, slope_high=slope,
             cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero,
             safe_value=value, safe_grad=grad)
    value_init, slope_init = value, slope

    def on_line(stepsize):
        v, g = loss_vag(params + stepsize * updates)
        return v, g, _dot(g, updates)

    count, interval_found = 0, False
    while True:
        if not interval_found:
            # search for an interval that satisfies the curvature condition
            new = zero + 1.0 if count == 0 else LS_INCREASE * s["stepsize"]
            v, g, sl = on_line(new)
            dec, curv = _errors(new, v, sl, value_init, slope_init)
            err = torch.maximum(dec, curv)
            safe = dec <= 0.0
            s["safe_stepsize"] = torch.where(safe, new, s["safe_stepsize"])
            s["safe_value"] = torch.where(safe, v, s["safe_value"])
            s["safe_grad"] = torch.where(safe, g, s["safe_grad"])
            set_high = (dec > 0.0) | ((v >= s["value"]) & (count > 0))
            set_low = (sl >= 0.0) & ~set_high
            prev = (s["stepsize"], s["value"], s["slope"])
            low = tuple(torch.where(set_low, a, b) for a, b in zip((new, v, sl), prev))
            high = tuple(torch.where(set_low, a, b) for a, b in zip(prev, (new, v, sl)))
            s["low"], s["value_low"], s["slope_low"] = low
            s["high"], s["value_high"], s["slope_high"] = high
            s["cubic_ref"], s["value_cubic_ref"] = low[0], low[1]
            found = set_high | set_low | (err <= 0.0)
            done = err <= 0.0
            failed = ~done & (count + 1 >= LS_MAX_STEPS)
        else:
            low, vlow, slow = s["low"], s["value_low"], s["slope_low"]
            high, vhigh, shigh = s["high"], s["value_high"], s["slope_high"]
            delta = torch.abs(high - low)
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            too_small = delta <= LS_INTERVAL_THRESHOLD
            cub = _cubicmin(low, vlow, slow, high, vhigh, s["cubic_ref"],
                            s["value_cubic_ref"])
            use_cubic = (cub > left + 0.2 * delta) & (cub < right - 0.2 * delta)
            quad = _quadmin(low, vlow, slow, high, vhigh)
            use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (quad < right - 0.1 * delta)
            use_bis = ~use_cubic & ~use_quad
            new = torch.where(use_cubic, cub, s["cubic_ref"])
            new = torch.where(use_quad, quad, new)
            new = torch.where(use_bis, (low + high) / 2.0, new)
            v, g, sl = on_line(new)
            dec, curv = _errors(new, v, sl, value_init, slope_init)
            err = torch.maximum(dec, curv)
            upd_safe = (dec <= 0.0) & (v < s["safe_value"])
            s["safe_stepsize"] = torch.where(upd_safe, new, s["safe_stepsize"])
            s["safe_value"] = torch.where(upd_safe, v, s["safe_value"])
            s["safe_grad"] = torch.where(upd_safe, g, s["safe_grad"])
            done = err <= 0.0
            high_to_mid = (dec > 0.0) | (v >= vlow)
            high_to_low = ((sl * (high - low)) >= 0.0) & ~high_to_mid
            low_to_mid = ~high_to_mid
            nh = tuple(torch.where(high_to_mid, a, b) for a, b in zip((new, v, sl), (high, vhigh, shigh)))
            nh = tuple(torch.where(high_to_low, a, b) for a, b in zip((low, vlow, slow), nh))
            nl = tuple(torch.where(low_to_mid, a, b) for a, b in zip((new, v, sl), (low, vlow, slow)))
            moved_high = high_to_mid | high_to_low
            s["cubic_ref"] = torch.where(moved_high, high, low)
            s["value_cubic_ref"] = torch.where(moved_high, vhigh, vlow)
            s["high"], s["value_high"], s["slope_high"] = nh
            s["low"], s["value_low"], s["slope_low"] = nl
            found = torch.as_tensor(True, device=value.device)
            failed = ~done & ((count + 1 >= LS_MAX_STEPS) | (too_small & (s["safe_stepsize"] > 0.0)))
        s.update(stepsize=new, value=v, grad=g, slope=sl, decrease_error=dec)
        count += 1
        syncs.count += 1
        interval_found, done_h, failed_h = torch.stack([found, done, failed]).tolist()
        if failed_h:
            # fall back on the best step with a sufficient decrease (or
            # none, when even the first step left the domain)
            use_safe = (s["safe_stepsize"] > 0.0) | torch.isinf(s["decrease_error"])
            return (torch.where(use_safe, s["safe_stepsize"], s["stepsize"]),
                    torch.where(use_safe, s["safe_value"], s["value"]),
                    torch.where(use_safe, s["safe_grad"], s["grad"]))
        if done_h:
            return s["stepsize"], s["value"], s["grad"]


def _lbfgs_minimize(loss_vag, z0, max_iters, tol, syncs):
    """Minimize a loss from ``z0`` (d,) as ``optax.lbfgs()`` does inside
    the JAX package's ``fit_map`` loop, stopping once |grad| <= tol or
    after ``max_iters`` iterations. ``loss_vag(z) -> (value (), grad
    (d,))``. Returns (z, grad, iterations)."""
    d = z0.shape[0]
    dt, dev = z0.dtype, z0.device
    s_mem = torch.zeros(MEMORY, d, dtype=dt, device=dev)
    y_mem = torch.zeros(MEMORY, d, dtype=dt, device=dev)
    rho = torch.zeros(MEMORY, dtype=dt, device=dev)
    prev_params = torch.zeros_like(z0)
    prev_updates = torch.zeros_like(z0)
    # the line search's value and grad at its accepted point (inf:
    # none yet)
    ls_value = torch.full((), math.inf, dtype=dt, device=dev)
    ls_grad = torch.zeros_like(z0)
    z = z0
    _, g = loss_vag(z)
    it = 0
    while it < max_iters:
        syncs.count += 1
        go, ls_finite = torch.stack(
            [torch.linalg.vector_norm(g) > tol, torch.isfinite(ls_value)]).tolist()
        if not go:
            break
        value, grad = (ls_value, ls_grad) if ls_finite else loss_vag(z)
        # scale_by_lbfgs: store the last pair, then precondition
        mi, pi = it % MEMORY, (it - 1) % MEMORY
        if it > 0:
            dp, du = z - prev_params, grad - prev_updates
            vd = _dot(du, dp)
            w = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            s_mem[pi], y_mem[pi], rho[pi] = dp, du, w
            den = _dot(du, du)
            gamma = torch.where(den > 0.0, vd / den, torch.ones_like(den))
        else:
            s_mem[pi], y_mem[pi], rho[pi] = 0.0, 0.0, 0.0
            gamma = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad), 1.0)
        order = [(mi + j) % MEMORY for j in range(MEMORY)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = rho[i] * _dot(s_mem[i], vec)
            vec = vec + (-alphas[i]) * y_mem[i]
        vec = gamma * vec
        for i in order:
            beta = rho[i] * _dot(y_mem[i], vec)
            vec = vec + (alphas[i] - beta) * s_mem[i]
        prev_params, prev_updates = z, grad
        direction = -vec
        step, ls_value, ls_grad = _zoom_linesearch(loss_vag, z, direction, value,
                                                   grad, syncs)
        z = z + step * direction
        g = ls_grad
        it += 1
    return z, g, it


def fit_map(ir_or_model, *, init=None, seed=0, max_iters=1000, tol=1e-5,
            jacobian=True, ncp=False, data=None, device=None, noise=None):
    """Maximum a posteriori point (Stan `optimize`, PyMC `find_MAP`) on
    ``device`` (default ``"cuda"``; a compiled model keeps its own).

    ``ncp=False`` by default: the mode users mean is the one of the
    model as written. The start is ``init`` (constrained values), the
    origin when ``seed`` is None, else 0.1 * ``noise`` with ``noise``
    (d,) standard normals (drawn from ``seed`` when not given).

    Returns ``(point, info)``: ``point`` maps each free RV to its
    constrained MAP value; ``info`` has logp / converged / iters /
    grad_norm (Python scalars), z_map and the run's host_syncs."""
    model = _as_model(ir_or_model, ncp, device)
    dtype, dev = default_dtype(), model.device
    d = model.size
    ddata = _run_data(model, data)
    obj_vag, obj = _objective(model, ddata, jacobian)

    if init is not None:
        z0 = model.unconstrain(init).to(dtype)
    elif seed is None:
        z0 = torch.zeros(d, dtype=dtype, device=dev)
    else:
        if noise is None:
            noise = _cpu_normals(seed, (d,))
        z0 = 0.1 * torch.as_tensor(noise, dtype=dtype, device=dev)

    if d == 0:  # fully observed model: nothing to optimize
        lp = obj(z0.reshape(1, 0))
        return {}, {"logp": float(lp[0]), "converged": True, "iters": 0,
                    "grad_norm": 0.0, "host_syncs": 0}

    def loss_vag(z):
        v, g = obj_vag(z.unsqueeze(0))
        return -v[0], -g[0]

    syncs = HostSyncs()
    z, g, iters = _lbfgs_minimize(loss_vag, z0, max_iters, tol, syncs)
    gnorm = float(torch.linalg.vector_norm(g))
    point = {k: v[0].cpu().numpy()
             for k, v in model.constrain(z.unsqueeze(0), ddata).items()}
    return point, {
        "logp": float(obj(z.unsqueeze(0))[0]),
        "converged": bool(gnorm <= tol) and np.isfinite(gnorm),
        "iters": int(iters),
        "grad_norm": gnorm,
        "z_map": z.cpu().numpy(),
        "host_syncs": syncs.count,
    }


def hessian(model, z, data=None):
    """(d, d) Hessian of the model's log-density at one flat point, by
    the double backward of the eager ``model.logp``."""
    return torch.autograd.functional.hessian(
        lambda x: model.logp(x.unsqueeze(0), data)[0], z)


def laplace(ir_or_model, *, draws=1000, seed=0, init=None, max_iters=1000,
            ncp=False, data=None, jitter=1e-8, psir=False, device=None,
            start_noise=None, noise=None):
    """Laplace (quadratic) approximation: N(z_map, (-H)^-1) in the
    unconstrained space, pushed through the constraint transforms.

    Returns ``(trace, info)`` with trace arrays shaped (1, draws,
    *event); ``info`` adds the MAP report, the jitter used and the
    covariance's log-determinant. The jitter escalates through 1e-6,
    1e-4 and 1e-2 until the Cholesky factor exists. ``psir=True``
    resamples the draws by Pareto-smoothed importance resampling
    (``info["psir"]``). ``start_noise`` (d,) and ``noise`` (draws, d)
    inject the start's and the draws' standard normals."""
    model = _as_model(ir_or_model, ncp, device)
    point, info = fit_map(model, init=init, seed=seed, max_iters=max_iters,
                          jacobian=True, data=data, noise=start_noise)
    d = model.size
    if d == 0:
        return {}, info
    dtype, dev = default_dtype(), model.device
    ddata = _run_data(model, data)
    z_map = torch.as_tensor(info["z_map"], device=dev)

    h = hessian(model, z_map, ddata)
    prec = -(h + h.T) / 2.0
    eye = torch.eye(d, dtype=prec.dtype, device=dev)
    chol, used = None, None
    for j in (jitter,) + LADDER:
        c, err = torch.linalg.cholesky_ex(prec + j * eye)
        if int(err) == 0 and bool(torch.isfinite(c).all()):
            chol, used = c, j
            break
    if chol is None:
        raise ValueError(
            "Hessian at the mode is not negative definite (model may be "
            "improper or the optimizer did not converge; "
            f"grad_norm={info['grad_norm']:.3g})")

    if noise is None:
        noise = _cpu_normals(1 if seed is None else seed + 1, (draws, d))
    eps = torch.as_tensor(noise, dtype=dtype, device=dev)
    # z ~ N(z_map, prec^-1): solve L^T x = eps
    zs = z_map + torch.linalg.solve_triangular(chol.T, eps.T, upper=True).T

    log_diag = torch.log(torch.diagonal(chol))
    info = dict(info, hessian_jitter=used,
                cov_logdet=float(-2.0 * torch.sum(log_diag)))
    if psir:
        from exmc_tpu_torch.psir import psir as _psir

        # logq(z) = 0.5 logdet(prec) - d/2 log 2pi - 0.5 |L^T (z - z_map)|^2,
        # and L^T (z - z_map) is exactly the eps each draw was built from
        logq = (torch.sum(log_diag) - 0.5 * d * math.log(2.0 * math.pi)
                - 0.5 * torch.sum(eps * eps, dim=-1))
        trace, psir_info = _psir(model, zs, logq.cpu().numpy(),
                                 seed=seed if seed is not None else 0, data=data)
        info["psir"] = psir_info
        return trace, info
    named = model.constrain(zs, ddata)
    return {k: v.cpu().numpy()[None] for k, v in named.items()}, info
