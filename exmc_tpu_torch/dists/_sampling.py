"""Draws from an explicit ``torch.Generator``, on its device, in float32:
the primitives the distributions' ``sample`` methods share."""

import torch

from exmc_tpu_torch.config import default_dtype


def as_tensor(v, generator):
    return torch.as_tensor(v, dtype=default_dtype(), device=generator.device)


def full_shape(shape, *params):
    return torch.broadcast_shapes(tuple(shape), *(torch.as_tensor(p).shape
                                                  for p in params))


def randn(shape, generator):
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=default_dtype())


def rand(shape, generator):
    """Uniform on the open interval (0, 1)."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device,
                   dtype=default_dtype())
    return torch.clamp(u, torch.finfo(u.dtype).tiny, 1.0 - 2.0 ** -24)


def exponential(shape, generator):
    e = torch.empty(tuple(shape), device=generator.device, dtype=default_dtype())
    return e.exponential_(generator=generator)


def gamma(alpha, shape, generator):
    """Gamma(alpha, 1) by Marsaglia-Tsang rejection, alpha < 1 boosted
    through Gamma(alpha + 1) U^(1/alpha)."""
    a = as_tensor(alpha, generator)
    shape = full_shape(shape, a)
    a = a.expand(shape)
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.ones(shape, dtype=a.dtype, device=a.device)
    done = torch.zeros(shape, dtype=torch.bool, device=a.device)
    while not bool(done.all()):
        x = randn(shape, generator)
        v = (1.0 + c * x) ** 3
        u = rand(shape, generator)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
    u = rand(shape, generator)
    return torch.where(boost, out * u ** (1.0 / a), out)


def binomial(n, p, shape, generator):
    n, p = as_tensor(n, generator), as_tensor(p, generator)
    shape = full_shape(shape, n, p)
    return torch.binomial(n.expand(shape).contiguous(),
                          p.expand(shape).contiguous(), generator=generator)


def poisson(rate, shape, generator):
    rate = as_tensor(rate, generator)
    return torch.poisson(rate.expand(full_shape(shape, rate)).contiguous(),
                         generator=generator)


def categorical(logits, shape, generator):
    """Integer-coded draws (as float32) over the last axis of ``logits``;
    ``shape`` is the batch shape of the draws."""
    logits = as_tensor(logits, generator)
    batch = full_shape(shape, logits[..., 0])
    probs = torch.softmax(logits.expand(batch + logits.shape[-1:]), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(flat, 1, replacement=True, generator=generator)
    return idx.reshape(batch).to(default_dtype())
