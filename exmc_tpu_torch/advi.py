"""ADVI: mean-field normal variational inference in the unconstrained
space (``exmc_tpu/advi.py``; Kucukelbir et al. 2017), on the same
compiled log-density as NUTS.

The reparameterized one-sample gradient (grad_mu = dlogp/dz,
grad_log_sigma = dlogp/dz * sigma * eps + 1), the closed-form entropy,
SGD (default) or Adam behind a global-norm clip of 10, each written here
with optax's formulas as tensor functions, since a step with a
non-finite result is rejected together with its optimizer state (which
``torch.optim`` cannot roll back). The steps run in windows of
``window``; with ``early_stop`` the fit stops once consecutive
window-mean ELBOs agree to relative ``tol``, which the host reads once
per window (one sync). Steps never run are NaN in ``elbo_history``.

Randomness: the step noise (steps, d) and the draw noise (draws, d) come
from a ``torch.Generator`` seeded from ``seed``, or are injected
(``noise=``, ``draw_noise=``).
"""

import math

import torch

from exmc_tpu_torch.compiler import CompiledModel, compile_logp
from exmc_tpu_torch.config import default_dtype

CLIP_NORM = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _clip_by_global_norm(gs):
    """optax.clip_by_global_norm(10) over a tuple of tensors."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
    trigger = norm < CLIP_NORM
    return tuple(torch.where(trigger, g, (g / norm) * CLIP_NORM) for g in gs)


def _sgd(lr):
    def init(params):
        return ()

    def update(grads, state):
        return tuple(-lr * g for g in grads), state

    return init, update


def _adam(lr):
    """optax.adam(lr): bias-corrected moments, eps outside the sqrt."""

    def init(params):
        return (torch.zeros((), dtype=params[0].dtype, device=params[0].device),
                tuple(torch.zeros_like(p) for p in params),
                tuple(torch.zeros_like(p) for p in params))

    def update(grads, state):
        count, ms, vs = state
        ms = tuple((1 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, ms))
        vs = tuple((1 - ADAM_B2) * (g * g) + ADAM_B2 * v for g, v in zip(grads, vs))
        count = count + 1.0
        c1, c2 = 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count
        ups = tuple(-lr * ((m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))
                    for m, v in zip(ms, vs))
        return ups, (count, ms, vs)

    return init, update


def _select(ok, new, old):
    """Elementwise ``where(ok, new, old)`` over nested tuples of tensors."""
    if isinstance(new, tuple):
        return tuple(_select(ok, a, b) for a, b in zip(new, old))
    return torch.where(ok, new, old)


def advi_fit(ir, *, num_steps=5000, lr=0.01, seed=0, num_draws=1000,
             window=100, tol=1e-3, data=None, ncp=True, early_stop=True,
             optimizer="sgd", psir=False, device=None, noise=None,
             draw_noise=None):
    """Fit mean-field ADVI on ``device`` (default ``"cuda"``; a compiled
    model keeps its own). Returns a dict with ``mu``, ``sigma`` (the
    unconstrained-space variational parameters), ``draws`` (constrained
    trace, (1, num_draws, ...) arrays), ``draws_unconstrained``,
    ``elbo_history`` (num_steps,), ``converged_at``, ``steps_run`` and
    ``host_syncs``.

    ``noise``: the step noise, (n_windows * window, d) standard normals
    where n_windows = ceil(num_steps / window); ``draw_noise``:
    (num_draws, d)."""
    model = (ir if isinstance(ir, CompiledModel)
             else compile_logp(ir, ncp=ncp, device=device))
    dtype, dev = default_dtype(), model.device
    d = model.size
    ddata = None if data is None else model.device_data(data)
    vag = model.value_and_grad

    if optimizer == "adam":
        opt_init, opt_update = _adam(lr)
    elif optimizer == "sgd":
        opt_init, opt_update = _sgd(lr)
    else:
        raise ValueError(f"optimizer must be 'sgd' or 'adam', got {optimizer!r}")

    n_windows = max(1, -(-num_steps // window))  # ceil; pad to full windows
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if noise is None:
        noise = torch.randn(n_windows * window, d, generator=gen, dtype=dtype,
                            device=dev)
    noise = torch.as_tensor(noise, dtype=dtype, device=dev)
    if draw_noise is None:
        draw_noise = torch.randn(num_draws, d, generator=gen, dtype=dtype, device=dev)
    draw_noise = torch.as_tensor(draw_noise, dtype=dtype, device=dev)

    mu = torch.zeros(d, dtype=dtype, device=dev)
    log_sigma = torch.full((d,), -1.0, dtype=dtype, device=dev)
    opt_state = opt_init((mu, log_sigma))
    buf = torch.full((n_windows, window), math.nan, dtype=dtype, device=dev)
    neg_inf = torch.full((), -math.inf, dtype=dtype, device=dev)
    prev_mean = torch.full((), math.inf, dtype=dtype, device=dev)
    conv_w = torch.full((), -1, dtype=torch.int64, device=dev)
    w, syncs = 0, 0
    while w < n_windows:
        elbos = []
        for t in range(w * window, (w + 1) * window):
            eps = noise[t]
            sigma = torch.exp(log_sigma)
            z = mu + sigma * eps
            lp, grad = vag(z.unsqueeze(0), ddata)
            lp, grad = lp[0], grad[0]
            # reparameterized ascent gradients; +1 is the entropy's. The
            # optimizer minimizes, so they are negated.
            grads = _clip_by_global_norm((-grad, -(grad * sigma * eps + 1.0)))
            ups, opt_new = opt_update(grads, opt_state)
            mu_new, ls_new = mu + ups[0], log_sigma + ups[1]
            # non-finite-step rejection, the optimizer state included
            ok = (torch.isfinite(lp) & torch.isfinite(mu_new).all()
                  & torch.isfinite(ls_new).all())
            mu = torch.where(ok, mu_new, mu)
            log_sigma = torch.where(ok, ls_new, log_sigma)
            opt_state = _select(ok, opt_new, opt_state)
            elbos.append(torch.where(ok, lp + torch.sum(log_sigma), neg_inf))
        elbos = torch.stack(elbos)
        m = torch.mean(elbos)
        rel = torch.abs(m - prev_mean) / (torch.abs(prev_mean) + 1e-10)
        hit = (rel < tol) & (w >= 1)
        conv_w = torch.where((conv_w < 0) & hit, torch.full_like(conv_w, w + 1), conv_w)
        buf[w] = elbos
        prev_mean = m
        w += 1
        if early_stop:
            syncs += 1
            if int(conv_w) >= 0:
                break

    conv = int(conv_w)
    sigma = torch.exp(log_sigma)
    z = mu + sigma * draw_noise
    trace = {k: v.cpu().numpy()[None] for k, v in model.constrain(z, ddata).items()}
    result = {
        "mu": mu.cpu().numpy(),
        "sigma": sigma.cpu().numpy(),
        "draws": trace,
        "draws_unconstrained": z.cpu().numpy()[None],
        "elbo_history": buf.reshape(-1)[:num_steps].cpu().numpy(),
        "converged_at": conv * window if conv > 0 else None,
        "steps_run": w * window,
        "host_syncs": syncs,
    }
    if psir:
        # resample the mean-field draws toward the exact posterior;
        # result["psir"]["pareto_k"] answers "did the VI work?"
        from exmc_tpu_torch.psir import apply_psir_to_fit, diag_normal_logq

        logq = diag_normal_logq(z, mu, sigma).cpu().numpy()
        result = apply_psir_to_fit(result, model, logq, seed=seed + 101, data=data)
    return result
