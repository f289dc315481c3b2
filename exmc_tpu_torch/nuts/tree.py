"""Iterative multinomial NUTS transition, batched over chains
(``exmc_tpu/nuts/tree.py``).

The JAX kernel is one chain's transition, vmapped; its two nested
``lax.while_loop``s (doublings, and leaves within a subtree) become
per-chain masked loops here (see ``masked.py``): a chain that has
stopped keeps every field of its carry, so its result does not depend
on the other chains.

Semantics, as in the reference:

* leaf: divergence iff ``~(delta >= -1000)`` (a NaN delta diverges);
  uncapped multinomial log-weight = delta; accept term
  min(1, exp(delta)).
* within-subtree merge: progressive multinomial, each new leaf replaces
  the proposal w.p. exp(lw_leaf - lsw_new).
* outer merge: biased progressive, the subtree's proposal wins w.p.
  min(1, exp(lsw_subtree - lsw_trajectory)).
* U-turn: generalized criterion rho . (M^-1 p) <= 0 at both ends, at
  every merge, plus Stan's two extended half-trajectory checks.

Checkpoints: within a subtree, even leaf n stores (r_n, rho through n,
r_{n-1}) at slot popcount(n); odd leaf n closes ctz(n+1)
sub-trajectories, checked at slots popcount(n)-1 down to
popcount(n)-ctz(n+1). Every chain still building a subtree is at the
same leaf (all start at leaf 0 of the same doubling and advance
together), so n, the slot and the checked range are host integers, and
the odd leaves' scratch-row write of the JAX kernel is not needed.

Randomness comes from a ``torch.Generator``, or is injected through
``rand`` (for lockstep tests against the JAX kernel):
``r0_z`` (C, d) standard normals, ``go_right`` (C, max_depth) bools,
``merge_logu`` (C, max_depth) and ``leaf_logu``
(C, max_depth, 2**(max_depth-1)) log-uniforms.
"""

import math
from typing import NamedTuple

import torch

from exmc_tpu_torch.config import DIVERGENCE_THRESHOLD
from exmc_tpu_torch.nuts.leapfrog import (
    Metric,
    kinetic_energy,
    leapfrog,
    sample_momentum,
    velocity,
    velocity_rows,
)
from exmc_tpu_torch.nuts.masked import HostSyncs, keep


def _dots(a, b):
    return torch.sum(a * b, dim=-1)


def _is_turning(metric, r_minus, r_plus, rho):
    """Generalized U-turn criterion: the trajectory persists only while
    rho . v(r) > 0 at BOTH boundaries. Per chain: (C,) bool."""
    return ((_dots(rho, velocity(metric, r_minus)) <= 0.0)
            | (_dots(rho, velocity(metric, r_plus)) <= 0.0))


def _iterative_uturn_check(metric, r_new, rho_through, ckpt, idx_min, idx_max):
    """U-turn check of every power-of-two sub-trajectory that ends at the
    current (odd) leaf: checkpoint slots idx_min..idx_max (host ints).

    For the sub-trajectory closing at slot i, its midpoint is the
    checkpoint at slot i+1, so Stan's extended checks are available:
      (a) full:  rho[s..n],             boundaries (r_s, r_n)
      (b) left:  rho[s..mid-1] + r_mid, boundaries (r_s, r_mid)
      (c) right: rho[mid..n] + r_{mid-1}, boundaries (r_{mid-1}, r_n)
    At i == idx_max (the leaf pair) all three collapse to (a)."""
    v_new = velocity(metric, r_new).unsqueeze(1)
    rho_n = rho_through.unsqueeze(1)
    ck_r = ckpt[:, idx_min:idx_max + 1, 0]
    ck_rho = ckpt[:, idx_min:idx_max + 1, 1]
    rho_sub = rho_n - ck_rho + ck_r
    turn = ((_dots(rho_sub, velocity_rows(metric, ck_r)) <= 0.0)
            | (_dots(rho_sub, v_new) <= 0.0)).any(-1)
    if idx_max > idx_min:
        lo_r = ckpt[:, idx_min:idx_max, 0]
        lo_rho = ckpt[:, idx_min:idx_max, 1]
        nx_r = ckpt[:, idx_min + 1:idx_max + 1, 0]
        nx_rho = ckpt[:, idx_min + 1:idx_max + 1, 1]
        nx_prev = ckpt[:, idx_min + 1:idx_max + 1, 2]
        rho_left = nx_rho - lo_rho + lo_r
        turn_b = ((_dots(rho_left, velocity_rows(metric, lo_r)) <= 0.0)
                  | (_dots(rho_left, velocity_rows(metric, nx_r)) <= 0.0))
        rho_right = rho_n - nx_rho + nx_r + nx_prev
        turn_c = ((_dots(rho_right, velocity_rows(metric, nx_prev)) <= 0.0)
                  | (_dots(rho_right, v_new) <= 0.0))
        turn = turn | (turn_b | turn_c).any(-1)
    return turn


class _Subtree(NamedTuple):
    n: torch.Tensor           # leaves built (C,) int32
    z: torch.Tensor           # far boundary of the subtree
    r: torch.Tensor
    g: torch.Tensor
    r_first: torch.Tensor     # momentum at the leaf next to the old trajectory
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    g_prop: torch.Tensor
    joint_prop: torch.Tensor
    lsw: torch.Tensor         # subtree multinomial log-sum-weight
    rho: torch.Tensor         # subtree momentum sum
    sum_accept: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor


def _popcount(n):
    return bin(n).count("1")


def _ctz(n):
    return (n & -n).bit_length() - 1


def _build_subtree(vag_fn, metric, eps_signed, depth, z0, r0, g0, joint0,
                   leaf_logu, active, max_depth, syncs):
    """Build up to 2^depth leapfrog steps outward from (z0, r0, g0) for
    the chains in ``active``; a chain stops on divergence or an internal
    U-turn. ``leaf_logu`` (C, 2^depth) holds one log-uniform per leaf."""
    c, d = z0.shape
    st = _Subtree(
        n=torch.zeros(c, dtype=torch.int32, device=z0.device),
        z=z0, r=r0, g=g0,
        r_first=torch.zeros_like(r0),
        z_prop=z0,
        logp_prop=torch.zeros_like(joint0),
        g_prop=g0,
        joint_prop=joint0,
        lsw=torch.full_like(joint0, -math.inf),
        rho=torch.zeros_like(r0),
        sum_accept=torch.zeros_like(joint0),
        turning=torch.zeros(c, dtype=torch.bool, device=z0.device),
        diverging=torch.zeros(c, dtype=torch.bool, device=z0.device),
    )
    ckpt = torch.zeros(c, max_depth, 3, d, dtype=z0.dtype, device=z0.device)
    neg_inf = torch.full_like(joint0, -math.inf)
    zero = torch.zeros_like(joint0)
    for n in range(1 << depth):
        live = active & ~st.turning & ~st.diverging
        # at leaf 0 ``live`` is ``active``, which the caller just tested
        if n > 0 and not syncs.any(live):
            break
        z, r, logp, g = leapfrog(vag_fn, st.z, st.r, st.g, eps_signed, metric)
        joint = logp - kinetic_energy(metric, r)
        delta = joint - joint0
        # NaN-safe: a non-finite delta counts as divergent
        div_leaf = ~(delta >= -DIVERGENCE_THRESHOLD)
        lw = torch.where(div_leaf, neg_inf, delta)  # uncapped weight
        accept = torch.where(div_leaf, zero,
                             torch.exp(torch.clamp_max(delta, 0.0)))
        rho = st.rho + torch.where(div_leaf[:, None], torch.zeros_like(r), r)
        r_first = r if n == 0 else st.r_first

        new_lsw = torch.logaddexp(st.lsw, lw)
        # the ~div_leaf guard keeps a (-inf) - (-inf) NaN out of the test
        take = live & ~div_leaf & (leaf_logu[:, n] < lw - new_lsw)

        if n % 2 == 0:
            slot = min(_popcount(n), max_depth - 1)
            rows = torch.stack([r, rho, st.r], dim=1)
            ckpt[:, slot] = keep(live, rows, ckpt[:, slot])
            turning = torch.zeros_like(st.turning)
        else:
            idx_max = _popcount(n) - 1
            idx_min = idx_max - _ctz(n + 1) + 1
            turning = ~div_leaf & _iterative_uturn_check(
                metric, r, rho, ckpt, idx_min, idx_max)

        st = _Subtree(
            n=st.n + live.to(torch.int32),
            z=keep(live, z, st.z),
            r=keep(live, r, st.r),
            g=keep(live, g, st.g),
            r_first=keep(live, r_first, st.r_first),
            z_prop=keep(take, z, st.z_prop),
            logp_prop=keep(take, logp, st.logp_prop),
            g_prop=keep(take, g, st.g_prop),
            joint_prop=keep(take, joint, st.joint_prop),
            lsw=keep(live, new_lsw, st.lsw),
            rho=keep(live, rho, st.rho),
            sum_accept=keep(live, st.sum_accept + accept, st.sum_accept),
            turning=keep(live, turning, st.turning),
            diverging=keep(live, div_leaf, st.diverging),
        )
    return st


class TreeState(NamedTuple):
    z_left: torch.Tensor
    r_left: torch.Tensor
    g_left: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    g_right: torch.Tensor
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    g_prop: torch.Tensor
    joint_prop: torch.Tensor
    rho: torch.Tensor
    lsw: torch.Tensor
    depth: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    n_leapfrog: torch.Tensor


def nuts_transition(vag_fn, metric: Metric, eps, q, logp, grad, max_depth,
                    max_depth_dyn=None, generator=None, rand=None,
                    syncs=None):
    """One NUTS transition of every chain. ``eps`` is (C,); ``max_depth``
    sizes the checkpoint stacks and ``max_depth_dyn`` (a host int) caps
    the doublings. Random draws come from ``generator`` unless ``rand``
    injects them (see the module docstring).

    Returns (q', logp', grad', stats) with (C,) stats "depth",
    "n_steps", "diverging", "accept_prob", "energy"."""
    c, d = q.shape
    syncs = HostSyncs() if syncs is None else syncs
    cap = max_depth if max_depth_dyn is None else int(max_depth_dyn)
    dev = q.device

    if rand is None:
        z = torch.randn(c, d, generator=generator, device=dev, dtype=q.dtype)
    else:
        z = rand["r0_z"]
    r0 = sample_momentum(metric, z)
    joint0 = logp - kinetic_energy(metric, r0)

    st = TreeState(
        z_left=q, r_left=r0, g_left=grad,
        z_right=q, r_right=r0, g_right=grad,
        z_prop=q, logp_prop=logp, g_prop=grad, joint_prop=joint0,
        rho=r0,
        lsw=torch.zeros_like(logp),  # initial point has weight exp(0)=1
        depth=torch.zeros(c, dtype=torch.int32, device=dev),
        turning=torch.zeros(c, dtype=torch.bool, device=dev),
        diverging=torch.zeros(c, dtype=torch.bool, device=dev),
        sum_accept=torch.zeros_like(logp),
        n_leapfrog=torch.zeros(c, dtype=torch.int32, device=dev),
    )

    for j in range(cap):
        # every chain still running has depth j
        active = ~st.turning & ~st.diverging
        if j > 0 and not syncs.any(active):
            break
        if rand is None:
            go_right = torch.rand(c, generator=generator, device=dev) < 0.5
            merge_logu = -torch.empty_like(logp).exponential_(generator=generator)
            leaf_logu = -torch.empty(c, 1 << j, dtype=q.dtype, device=dev
                                     ).exponential_(generator=generator)
        else:
            go_right = rand["go_right"][:, j]
            merge_logu = rand["merge_logu"][:, j]
            leaf_logu = rand["leaf_logu"][:, j, : 1 << j]
        eps_signed = torch.where(go_right, eps, -eps)[:, None]

        z0 = keep(go_right, st.z_right, st.z_left)
        r0b = keep(go_right, st.r_right, st.r_left)
        g0 = keep(go_right, st.g_right, st.g_left)

        sub = _build_subtree(vag_fn, metric, eps_signed, j, z0, r0b, g0,
                             joint0, leaf_logu, active, max_depth, syncs)
        ok = ~sub.turning & ~sub.diverging

        # biased progressive merge
        take = ok & (merge_logu < sub.lsw - st.lsw)
        lsw = torch.where(ok, torch.logaddexp(st.lsw, sub.lsw), st.lsw)

        # extend boundaries only when the subtree is valid
        ext_right = ok & go_right
        ext_left = ok & ~go_right
        z_right = keep(ext_right, sub.z, st.z_right)
        r_right = keep(ext_right, sub.r, st.r_right)
        g_right = keep(ext_right, sub.g, st.g_right)
        z_left = keep(ext_left, sub.z, st.z_left)
        r_left = keep(ext_left, sub.r, st.r_left)
        g_left = keep(ext_left, sub.g, st.g_left)
        rho = keep(ok, st.rho + sub.rho, st.rho)

        # U-turn across the merged trajectory + the two extended checks
        far_old = keep(go_right, st.r_left, st.r_right)
        adj_old = keep(go_right, st.r_right, st.r_left)
        turn_full = _is_turning(metric, r_left, r_right, rho)
        turn_ext1 = _is_turning(metric, far_old, sub.r_first,
                                st.rho + sub.r_first)
        turn_ext2 = _is_turning(metric, adj_old, sub.r, sub.rho + adj_old)
        turning = sub.turning | (ok & (turn_full | turn_ext1 | turn_ext2))

        new = TreeState(
            z_left=z_left, r_left=r_left, g_left=g_left,
            z_right=z_right, r_right=r_right, g_right=g_right,
            z_prop=keep(take, sub.z_prop, st.z_prop),
            logp_prop=keep(take, sub.logp_prop, st.logp_prop),
            g_prop=keep(take, sub.g_prop, st.g_prop),
            joint_prop=keep(take, sub.joint_prop, st.joint_prop),
            rho=rho,
            lsw=lsw,
            depth=st.depth + 1,
            turning=turning,
            diverging=sub.diverging,
            sum_accept=st.sum_accept + sub.sum_accept,
            n_leapfrog=st.n_leapfrog + sub.n,
        )
        st = TreeState(*(keep(active, a, b) for a, b in zip(new, st)))

    accept_prob = st.sum_accept / torch.clamp_min(st.n_leapfrog, 1).to(q.dtype)
    stats = {
        "depth": st.depth,
        "n_steps": st.n_leapfrog,
        "diverging": st.diverging,
        "accept_prob": accept_prob,
        "energy": -st.joint_prop,
    }
    return st.z_prop, st.logp_prop, st.g_prop, stats
