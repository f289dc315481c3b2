"""ChEES-HMC and SNAPER-HMC for many chains (``exmc_tpu/chees.py``;
Hoffman, Radul & Sountsov 2021; Sountsov & Hoffman 2022).

Every chain runs the same jittered number of leapfrog steps per
iteration, L = clip(ceil(u T / eps), 1, max_num_steps) with one Halton
number u per iteration, so the whole batch moves in lockstep. The JAX
package runs the two scans (warmup with adaptation, then sampling) as one
program; the port runs them as a host loop over batched tensors: L is
read on the host once per iteration (one sync), then L leapfrog steps,
each a value-and-grad of the chain batch (a CUDA graph replay on the
card) and a few elementwise ops. Nothing else in an iteration waits for
the device.

Adaptation, as in the JAX package: trajectory length T by Adam on the
ChEES (or, for SNAPER, the principal-component projected) criterion
gradient, averaged into logT_bar; the step size by dual averaging on the
harmonic-mean accept probability; the diagonal metric by the chains'
Welford moments merged at the window ends of the NUTS schedule; SNAPER's
principal component by a damped power iteration.

The chains form G groups of consecutive chains, each an independent
ensemble adapting from its own chains only (``run_groups``; SBC runs one
replication a group): every cross-chain statistic is the one-ensemble
function vmapped over the group axis, and each group has its own step
size, T, metric and L. ``sample_chees`` is the run of one group.

Randomness: per iteration a momentum draw z (C, d) and an accept
uniform (C,) from one ``torch.Generator`` seeded from ``seed`` (inits
from a second one, as in the NUTS sampler); ``_run`` takes a carry and
``rand(i) -> (z, un)``, so that tests can start from the JAX package's
state with its draws (it folds a key per chain and iteration).

``mesh=`` splits the chains over the mesh's "dp" ranks
(``parallel.sharding``). Each rank draws the whole (C, d) noise from
the same generator and keeps its rows, and redraws invalid inits as
the whole batch while a chain of any rank is invalid, so it runs the
chains the one-process run would run there; the cross-chain reductions (the
criterion's means and sums, the harmonic accept, the pooled Welford
merge, SNAPER's power iteration) are ``all_reduce``s, one or two per
reduction; the step-size search of global chain 0 is broadcast from the
first rank. Every rank then holds the same tuning, so the same L every
iteration (the Halton jitter is the same everywhere): the lockstep
survives sharding, and ``sample_chees`` checks it at the end of the
run (``_check_lockstep``). Sums in another order give other rounding, so a
W-rank run is not bit for bit the one-process run.
"""

import math
from functools import partial

import numpy as np
import torch
from torch.utils._pytree import tree_map

from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.engines_common import (
    KernelCache,
    postprocess_ensemble,
    run_data,
)
from exmc_tpu_torch.nuts.leapfrog import (
    Metric,
    kinetic_energy,
    leapfrog,
    sample_momentum,
    velocity,
)
from exmc_tpu_torch.nuts.masked import HostSyncs
from exmc_tpu_torch.nuts.mass_matrix import (
    welford_finalize,
    welford_init,
    welford_merge_across,
    welford_update,
)
from exmc_tpu_torch.nuts.step_size import (
    da_finalize,
    da_init,
    da_update,
    find_reasonable_epsilon,
)
from exmc_tpu_torch.nuts.warmup import build_schedule

# Adam hyperparameters of the log-trajectory-length update
ADAM_LR = 0.025
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
EPS_SEARCH_SEED_OFFSET = 424_243


def _halton_base2(n):
    """First n van der Corput base-2 numbers in (0, 1), u_i = bitrev(i+1)."""
    i = np.arange(1, n + 1, dtype=np.uint64)
    u = np.zeros(n, dtype=np.float64)
    f = 0.5
    while i.any():
        u += f * (i & 1)
        i >>= 1
        f *= 0.5
    return u


def _psum(group, *tensors):
    """The sums of ``tensors`` over the ranks of ``group`` (None: as they
    are), in one ``all_reduce``."""
    return tensors if group is None else group.psum(*tensors)


def _weights(q1, v1, accept, q0, group=None):
    """Accept-prob weights with non-finite endpoints masked out, their
    clamped sum, q1 and v1 with those rows zeroed, and the weighted
    means of q1 and q0 (over every rank of ``group``)."""
    finite = (torch.isfinite(q1).all(-1) & torch.isfinite(v1).all(-1)
              & torch.isfinite(accept))
    w = torch.where(finite, accept, torch.zeros_like(accept))
    fin = finite.unsqueeze(-1)
    q1z = torch.where(fin, q1, torch.zeros_like(q1))
    v1z = torch.where(fin, v1, torch.zeros_like(v1))
    wsum, s1, s0 = _psum(group, torch.sum(w), torch.sum(w.unsqueeze(-1) * q1z, dim=0),
                         torch.sum(w.unsqueeze(-1) * q0, dim=0))
    wsum = torch.clamp_min(wsum, 1e-6)
    return w, wsum, q1z, v1z, s1 / wsum, s0 / wsum


def _criterion(w, wsum, delta, proj, tlen, group):
    """sum w delta proj tlen / sum w |delta|, the sums over ``group``."""
    g, scale = _psum(group, torch.sum(w * (delta * proj * tlen)),
                     torch.sum(w * torch.abs(delta)))
    return (g / wsum) / torch.clamp_min(scale / wsum, 1e-10)


def _chees_grad(q0, q1, v1, accept, tlen, group=None):
    """Accept-weighted ChEES gradient estimate with respect to log T,
    normalized by the criterion's magnitude (the centering means are
    accept-weighted, non-finite endpoints masked)."""
    w, wsum, q1z, v1z, m1, m0 = _weights(q1, v1, accept, q0, group)
    c0 = q0 - m0
    c1 = q1z - m1
    delta = torch.sum(c1 * c1, dim=-1) - torch.sum(c0 * c0, dim=-1)
    dirn = torch.sum(c1 * v1z, dim=-1)
    return _criterion(w, wsum, delta, dirn, tlen, group)


def _harmonic_accept(accept, group=None):
    """Harmonic-mean accept probability; non-finite accepts count ~0."""
    a = torch.where(torch.isfinite(accept), accept, torch.zeros_like(accept))
    a = torch.clamp(a, 1e-10, 1.0)
    n = accept.shape[0] * (1 if group is None else group.size)
    (inv_sum,) = _psum(group, torch.sum(1.0 / a))
    return n / inv_sum


def _snaper_grad(q0, q1, v1, accept, tlen, pc, inv, group=None):
    """The SNAPER criterion gradient: ChEES's with the squared norm
    replaced by the squared projection on the principal component of
    the preconditioned posterior."""
    s = torch.sqrt(inv)
    w, wsum, q1z, v1z, m1, m0 = _weights(q1, v1, accept, q0, group)
    a0 = ((q0 - m0) / s) @ pc
    a1 = ((q1z - m1) / s) @ pc
    dv = (v1z / s) @ pc
    delta = a1 * a1 - a0 * a0
    return _criterion(w, wsum, delta, a1 * dv, tlen, group)


def _oja_update(pc, q, inv, enabled, t, group=None):
    """Damped power-iteration update of the principal component from
    the chain batch, in preconditioned coordinates; a fully masked
    iteration leaves it unchanged."""
    s = torch.sqrt(inv)
    w = enabled.to(q.dtype)
    w_tot, q_sum = _psum(group, torch.sum(w), torch.sum(w.unsqueeze(-1) * q, dim=0))
    wsum = torch.clamp_min(w_tot, 1.0)
    mean_q = q_sum / wsum
    z = torch.where(enabled.unsqueeze(-1), (q - mean_q) / s, torch.zeros_like(q))
    (g,) = _psum(group, z.T @ (z @ pc))
    g = g / wsum
    gn = torch.sqrt(torch.sum(g * g))
    g_hat = torch.where(gn > 1e-12, g / torch.clamp_min(gn, 1e-12), pc)
    beta = (t + 9.0) ** -0.75
    new = (1.0 - beta) * pc + beta * g_hat
    new = new / torch.sqrt(torch.clamp_min(torch.sum(new * new), 1e-12))
    return torch.where(w_tot > 0.5, new, pc)


class _Kernel:
    """The run's constants: the Halton jitter and the warmup schedule."""

    def __init__(self, num_warmup, num_samples):
        total = num_warmup + num_samples
        self.num_warmup, self.num_samples = num_warmup, num_samples
        self.halton = _halton_base2(total).astype(np.float32)
        schedule = build_schedule(num_warmup, max_depth=10)
        self.update_mass = schedule.update_mass
        self.window_end = schedule.window_end


def _per_group(fn, g, *args, in_dims=0):
    """``fn`` of one ensemble applied to each of ``g`` groups: chain
    tensors (``in_dims`` 0) come viewed as (G, M, ...) and per-group
    state with its leading G axis; an ``in_dims`` of None passes the
    argument whole. One group calls ``fn`` itself, with no batching rule
    in between, so a single ensemble computes exactly what ``fn`` does."""
    dims = in_dims if isinstance(in_dims, tuple) else (in_dims,) * len(args)
    if g == 1:
        out = fn(*(a if dim is None else tree_map(lambda t: t[0], a)
                   for a, dim in zip(args, dims)))
        return tree_map(lambda t: t.unsqueeze(0), out)
    return torch.func.vmap(fn, in_dims=dims)(*args)


def _by_group(t, g):
    return t.reshape((g, t.shape[0] // g) + tuple(t.shape[1:]))


def _init_carry(vag_first, q0, logp0, grad0, z_eps, criterion, syncs, group=None):
    """The carry the JAX package's warmup scan starts from, after its
    init search, for G = ``z_eps.shape[0]`` groups of consecutive chains:
    each group's step size searched from its first chain with its row of
    ``z_eps`` (G, d), and T = 8 eps. ``vag_first`` is the value-and-grad
    of those G chains (with their data rows). The tuning state has a
    leading G axis. Under a ``group`` of ranks (one ensemble) the step
    size is the first rank's, that is global chain 0's."""
    c, d = q0.shape
    g = z_eps.shape[0]
    m = c // g
    dt, dev = q0.dtype, q0.device
    ones = torch.ones(d, dtype=dt, device=dev)
    eps0 = find_reasonable_epsilon(vag_first, q0[::m], logp0[::m], grad0[::m],
                                   Metric(inv=ones, chol_inv=torch.sqrt(ones)), z_eps,
                                   syncs=syncs)
    if group is not None:
        eps0 = group.broadcast(eps0)
    log_t0 = torch.log(8.0 * eps0)
    zero = torch.zeros(g, dtype=dt, device=dev)
    carry = dict(q=q0, logp=logp0, grad=grad0, da=da_init(eps0), logT=log_t0,
                 logT_bar=log_t0, adam_m=zero, adam_v=zero, adam_t=zero,
                 inv=torch.ones(g, d, dtype=dt, device=dev), wf=welford_init(c, d, dt, dev))
    if criterion == "snaper":
        carry["pc"] = torch.full((g, d), 1.0 / math.sqrt(d), dtype=dt, device=dev)
    return carry


def _transition(vag_fn, carry, u, eps, T, z, un, max_num_steps):
    """One jittered-trajectory HMC move of the whole batch, each group
    with its own eps and T (G,) and so its own L = clip(ceil(u T / eps),
    1, max_num_steps): one host read of the G counts, then as many steps
    as the longest, a group's chains frozen once its L steps are done."""
    c = carry["q"].shape[0]
    m = c // eps.shape[0]
    inv = carry["inv"].repeat_interleave(m, 0)
    metric = Metric(inv=inv, chol_inv=torch.sqrt(inv))
    # a NaN converts to 0 and an overflow saturates, as XLA's float-to-int
    # conversion does
    lf = torch.nan_to_num(torch.ceil(u * T / eps), nan=0.0,
                          posinf=float(max_num_steps), neginf=0.0)
    n_steps = torch.clamp(lf, 1, max_num_steps).to(torch.int64)
    n_host = n_steps.cpu().numpy()  # the one sync
    tlen = n_steps.to(eps.dtype) * eps  # the length actually integrated
    eps_chain = eps.repeat_interleave(m).unsqueeze(-1)
    p0 = sample_momentum(metric, z)
    joint0 = carry["logp"] - kinetic_energy(metric, p0)
    q1, p1, logp1, grad1 = carry["q"], p0, carry["logp"], carry["grad"]
    if n_host.min() == n_host.max():
        for _ in range(int(n_host[0])):
            q1, p1, logp1, grad1 = leapfrog(vag_fn, q1, p1, grad1, eps_chain, metric)
    else:
        n_chain = n_steps.repeat_interleave(m).unsqueeze(-1)
        for step in range(int(n_host.max())):
            qn, pn, ln, gn = leapfrog(vag_fn, q1, p1, grad1, eps_chain, metric)
            act = step < n_chain
            q1, p1, grad1 = (torch.where(act, qn, q1), torch.where(act, pn, p1),
                             torch.where(act, gn, grad1))
            logp1 = torch.where(act[:, 0], ln, logp1)
    joint1 = logp1 - kinetic_energy(metric, p1)
    delta = joint1 - joint0
    # a non-finite gradient is rejected even with a finite energy: grad
    # is only refreshed on accept, and an accepted NaN grad poisons
    # every later trajectory
    ok = torch.isfinite(delta) & torch.isfinite(grad1).all(-1)
    delta = torch.where(ok, delta, torch.full_like(delta, -math.inf))
    accept_prob = torch.exp(torch.clamp_max(delta, 0.0))
    take = un < accept_prob
    tk = take.unsqueeze(-1)
    return dict(q=torch.where(tk, q1, carry["q"]),
                logp=torch.where(take, logp1, carry["logp"]),
                grad=torch.where(tk, grad1, carry["grad"]),
                accept_prob=accept_prob, diverging=delta < -1000.0,
                energy=-torch.where(take, joint1, joint0), num_steps=n_host,
                metric=metric, q1=q1, p1=p1, tlen=tlen)


def _warm_step(vag_fn, carry, i, kernel, z, un, target_accept, max_num_steps,
               criterion, group=None):
    g = carry["logT"].shape[0]
    eps = torch.exp(carry["da"].log_eps)
    T = torch.exp(carry["logT"])
    mv = _transition(vag_fn, carry, float(kernel.halton[i]), eps, T, z, un,
                     max_num_steps)
    # trajectory length: Adam on the criterion gradient
    v1 = velocity(mv["metric"], mv["p1"])
    q0, q1, v1, acc = (_by_group(t, g) for t in (carry["q"], mv["q1"], v1,
                                                  mv["accept_prob"]))
    if criterion == "snaper":
        grad = _per_group(partial(_snaper_grad, group=group), g, q0, q1, v1, acc,
                          mv["tlen"], carry["pc"], carry["inv"])
    else:
        grad = _per_group(partial(_chees_grad, group=group), g, q0, q1, v1, acc,
                          mv["tlen"])
    t_adam = carry["adam_t"] + 1.0
    m = ADAM_B1 * carry["adam_m"] + (1 - ADAM_B1) * grad
    v = ADAM_B2 * carry["adam_v"] + (1 - ADAM_B2) * grad * grad
    m_hat = m / (1 - ADAM_B1 ** t_adam)
    v_hat = v / (1 - ADAM_B2 ** t_adam)
    log_t = carry["logT"] + ADAM_LR * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    log_t = torch.clamp(log_t, torch.log(eps), torch.log(eps * (max_num_steps - 1)))
    eta = (t_adam + 10.0) ** -0.75
    log_t_bar = eta * log_t + (1 - eta) * carry["logT_bar"]
    # step size: dual averaging on the harmonic-mean accept
    da = da_update(carry["da"], _per_group(partial(_harmonic_accept, group=group), g, acc),
                   target_accept)
    # pooled metric at the window ends; divergent draws excluded
    enabled = ~mv["diverging"] & bool(kernel.update_mass[i])
    wf = welford_update(carry["wf"], mv["q"], enabled)
    inv = carry["inv"]
    if kernel.window_end[i]:
        merged = _per_group(partial(welford_merge_across, group=group), g,
                            type(wf)(*(_by_group(f, g) for f in wf)))
        inv = welford_finalize(merged, inv)
        c, d = mv["q"].shape
        wf = welford_init(c, d, mv["q"].dtype, mv["q"].device)
    new = dict(q=mv["q"], logp=mv["logp"], grad=mv["grad"], da=da, logT=log_t,
               logT_bar=log_t_bar, adam_m=m, adam_v=v, adam_t=t_adam, inv=inv, wf=wf)
    if criterion == "snaper":
        t = torch.as_tensor(float(i), dtype=grad.dtype, device=grad.device)
        new["pc"] = _per_group(partial(_oja_update, group=group), g, carry["pc"],
                               _by_group(mv["q"], g),
                               carry["inv"], _by_group(enabled, g), t,
                               in_dims=(0, 0, 0, 0, None))
    return new, mv


def _run(vag_fn, carry, kernel, target_accept, max_num_steps, criterion, rand,
         syncs, on_iter=None, first=0, last=None, group=None):
    """Iterations ``first`` .. ``last`` (default: to the end) of the
    warmup and sampling from ``carry`` (its groups: the leading axis of
    its tuning state). ``rand(i) -> (z (C, d), un (C,))`` gives iteration
    i's draws; ``on_iter(i, carry, num_steps (G,))`` sees the carry after
    each. ``group``: the ranks holding the ensemble's other chains.
    Returns (carry, outs) with outs chains-first (C, samples run,
    ...) and ``num_steps`` every iteration's L (iterations run, G)."""
    total = kernel.num_warmup + kernel.num_samples
    last = total if last is None else last
    c, d = carry["q"].shape
    g = carry["logT"].shape[0]
    dt, dev = carry["q"].dtype, carry["q"].device
    ns = max(last - max(first, kernel.num_warmup), 0)
    outs = {"q": torch.empty(c, ns, d, dtype=dt, device=dev),
            "logp": torch.empty(c, ns, dtype=dt, device=dev),
            "accept_prob": torch.empty(c, ns, dtype=dt, device=dev),
            "diverging": torch.empty(c, ns, dtype=torch.bool, device=dev),
            "energy": torch.empty(c, ns, dtype=dt, device=dev)}
    num_steps = []
    eps = T = None
    for i in range(first, last):
        z, un = rand(i)
        syncs.count += 1  # the G step counts
        if i < kernel.num_warmup:
            carry, mv = _warm_step(vag_fn, carry, i, kernel, z, un, target_accept,
                                   max_num_steps, criterion, group)
        else:
            if eps is None:  # the tuning is frozen from here on
                eps = da_finalize(carry["da"])
                T = torch.exp(carry["logT_bar"])
            mv = _transition(vag_fn, carry, float(kernel.halton[i]), eps, T, z, un,
                             max_num_steps)
            carry = dict(carry, q=mv["q"], logp=mv["logp"], grad=mv["grad"])
            k = i - max(first, kernel.num_warmup)
            for name in outs:
                outs[name][:, k] = mv[name]
        num_steps.append(mv["num_steps"])
        if on_iter is not None:
            on_iter(i, carry, mv["num_steps"])
    outs["num_steps"] = np.asarray(num_steps, np.int64).reshape(-1, g)
    return carry, outs


def run_groups(model, ddata, groups, chains_per_group, num_warmup, num_samples, seed,
               criterion="chees", target_accept=0.651, max_num_steps=1024,
               q_inits=None, kernel=None, group=None):
    """ChEES (or SNAPER) on ``groups`` independent ensembles of
    ``chains_per_group`` consecutive chains as one batch; ``ddata`` (a
    ``DeviceData`` or None) carries a leading axis of groups *
    chains_per_group rows, or 1. The chains start from ``q_inits`` (C, d)
    or overdispersed draws; inits, the step-size search's normals (G, d)
    and the per-iteration draws come from generators seeded from
    ``seed``. Returns (outs, final carry, host syncs).

    ``group`` (an ``AxisGroup``; one ensemble) splits the C chains over
    its ranks: this rank runs its block of rows of every draw, and outs
    hold its chains."""
    from exmc_tpu_torch.nuts.sampler import (
        CHAIN_SEED_STRIDE,
        INIT_SEED_OFFSET,
        _find_valid_init,
        _init_position,
    )

    c, d = groups * chains_per_group, model.size
    dt, dev = default_dtype(), model.device
    if group is not None and groups != 1:
        raise ValueError("chains split over ranks run one ensemble (groups=1)")
    rows = slice(None) if group is None else group.block(c, "num_chains")
    if ddata is not None and group is not None:
        ddata = ddata.rows(rows)

    def vag_fn(q):
        return model.value_and_grad(q, ddata)

    syncs = HostSyncs()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if q_inits is None:
        init_gen = torch.Generator(device=dev)
        init_gen.manual_seed(seed * CHAIN_SEED_STRIDE + INIT_SEED_OFFSET)
        q_inits = _init_position(init_gen, (c, d), dt, dev)
    q0, logp0, grad0 = _find_valid_init(vag_fn, q_inits[rows], gen, syncs=syncs,
                                         group=group)
    eps_gen = torch.Generator(device=dev)
    eps_gen.manual_seed(seed + EPS_SEARCH_SEED_OFFSET)
    z_eps = torch.randn(groups, d, generator=eps_gen, dtype=dt, device=dev)
    m = q0.shape[0] // groups
    first = None if ddata is None else ddata.rows(slice(None, None, m))
    carry = _init_carry(lambda q: model.value_and_grad(q, first), q0, logp0, grad0, z_eps,
                        criterion, syncs, group)

    def rand(i):
        # the whole batch's draws, this rank's rows kept
        return (torch.randn(c, d, generator=gen, dtype=dt, device=dev)[rows],
                torch.rand(c, generator=gen, dtype=dt, device=dev)[rows])

    kernel = kernel or _Kernel(num_warmup, num_samples)
    carry, outs = _run(vag_fn, carry, kernel, target_accept, max_num_steps, criterion,
                       rand, syncs, group=group)
    return outs, carry, syncs.count


def _check_lockstep(steps, group):
    """Raise if the ranks of ``group`` read other L (``steps``, one per
    iteration) at some iteration. Their tuning is made of the same sums
    on every rank, so their L should never differ."""
    every = group.gather_rows(np.asarray(steps, np.int64)[None, :])
    off = (every != every[:1]).any(axis=0)
    if off.any():
        raise RuntimeError(f"the ranks' trajectory lengths differ from iteration "
                           f"{int(np.argmax(off))} on: {every[:, off][:, :5].tolist()}")


_KERNEL_CACHE = KernelCache()


def clear_kernel_cache():
    _KERNEL_CACHE.clear()


def sample_chees(ir, *, num_chains=64, num_warmup=500, num_samples=1000,
                 seed=0, init=None, data=None, ncp=True,
                 target_accept=0.651, max_num_steps=1024, mesh=None,
                 return_unconstrained=False, criterion="chees", device=None):
    """Many-chain ChEES-HMC on ``device`` (default ``"cuda"``). Returns
    (trace, stats) like ``sample``: accept_prob / logp / energy /
    diverging are (chains, samples); step_size, trajectory_length,
    inv_mass and num_steps_mean are the frozen post-warmup tuning, and
    host_syncs counts the run's device-to-host reads (one per
    iteration for L, plus the init search's).

    ``target_accept`` defaults to the paper's 0.651; ``max_num_steps``
    caps L. ``init`` is a dict of constrained values that every chain
    starts from. ``mesh`` (``parallel.make_mesh``) splits the chains
    over its "dp" ranks, on the mesh's device; every rank returns the
    whole (trace, stats), chains in rank order, and its own host_syncs,
    or raises on every rank if their L differed at some iteration."""
    if criterion not in ("chees", "snaper"):
        raise ValueError(f"unknown criterion {criterion!r} (chees|snaper)")
    if num_chains < 2:
        raise ValueError("ChEES adaptation needs >= 2 chains for the "
                         "cross-chain criterion (use sample() for 1)")
    group = None
    if mesh is not None:
        dp = mesh.shape["dp"]
        if num_chains % dp != 0:
            raise ValueError(f"num_chains={num_chains} not divisible by dp={dp}")
        group = mesh.axis("dp")
        device = mesh.device if device is None else device
    key = (KernelCache.model_sig(ir, ncp), num_chains, num_warmup, num_samples,
           float(target_accept), int(max_num_steps), criterion)
    model, kernel = _KERNEL_CACHE.get_or_build(
        key, ir, ncp, device, lambda: _Kernel(num_warmup, num_samples))
    d = model.size
    if d == 0:
        return {}, {"note": "model has no free parameters"}
    ddata = run_data(ir, model, data)
    q_inits = None
    if init is not None:
        q_inits = model.unconstrain(init).to(default_dtype()).expand(num_chains, d).clone()
    outs, carry, n_syncs = run_groups(model, ddata, 1, num_chains, num_warmup, num_samples,
                                      seed, criterion, target_accept, max_num_steps,
                                      q_inits=q_inits, kernel=kernel, group=group)
    steps = outs.pop("num_steps")[:, 0]
    if group is not None:
        _check_lockstep(steps, group)
        outs = {k: group.gather_rows(v) for k, v in outs.items()}
    extra = {
        "step_size": da_finalize(carry["da"])[0].cpu().numpy(),
        "trajectory_length": torch.exp(carry["logT_bar"])[0].cpu().numpy(),
        "inv_mass": carry["inv"][0].cpu().numpy(),
        "num_steps_mean": float(steps[num_warmup:].mean()) if num_samples else float("nan"),
        "host_syncs": n_syncs,
    }
    if criterion == "snaper":
        extra["principal_component"] = carry["pc"][0].cpu().numpy()
    return postprocess_ensemble(outs, model, ddata, return_unconstrained, extra)


def sample_snaper(ir, **kwargs):
    """SNAPER-HMC: the ChEES kernel with the trajectory-length criterion
    projected onto an online estimate of the posterior's principal
    component in preconditioned space; stats also carry the learned
    ``principal_component``. Accepts every ``sample_chees`` keyword."""
    if kwargs.pop("criterion", "snaper") != "snaper":
        raise ValueError("sample_snaper is the criterion='snaper' entry "
                         "point; call sample_chees for criterion='chees'")
    return sample_chees(ir, criterion="snaper", **kwargs)
