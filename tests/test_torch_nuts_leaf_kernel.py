"""The NUTS tree's leaf step (``exmc_tpu_torch/nuts/leaf.py``): the
dispatch between the leaf kernel and the plain leaf, the plain leaf
against the eager tree it was moved out of, and the flag read as a host
sync, on the CPU; the kernel (``csrc/nuts_leaf.cu``) against the plain
leaf, leaf by leaf and over whole runs, on the card (``-m gpu``)."""

import math
import types

import numpy as np
import pytest
import torch

from exmc_tpu_torch import bench
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.config import DIVERGENCE_THRESHOLD
from exmc_tpu_torch.nuts import leaf, tree
from exmc_tpu_torch.nuts.leaf import LeafKernel, Subtree
from exmc_tpu_torch.nuts.leapfrog import kinetic_energy, leapfrog, make_metric, velocity, \
    velocity_rows
from exmc_tpu_torch.nuts.masked import HostSyncs, keep
from exmc_tpu_torch.nuts.sampler import NUTSSampler
from exmc_tpu_torch.nuts.tree import nuts_transition
from exmc_tpu_torch.utils import profiling

# ---------------------------------------------------------------------------
# the eager subtree build as it stood before the leaf moved into leaf.py
# (its popcount and ctz helpers inlined): the reference the plain leaf is
# held to bit for bit


def _dots(a, b):
    return torch.sum(a * b, dim=-1)


def _old_uturn_check(metric, r_new, rho_through, ckpt, idx_min, idx_max):
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


def _old_build_subtree(vag_fn, metric, eps_signed, depth, z0, r0, g0, joint0,
                       leaf_logu, active, max_depth, syncs):
    c, d = z0.shape
    st = Subtree(
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
        if n > 0 and not syncs.any(live):
            break
        z, r, logp, g = leapfrog(vag_fn, st.z, st.r, st.g, eps_signed, metric)
        joint = logp - kinetic_energy(metric, r)
        delta = joint - joint0
        div_leaf = ~(delta >= -DIVERGENCE_THRESHOLD)
        lw = torch.where(div_leaf, neg_inf, delta)
        accept = torch.where(div_leaf, zero,
                             torch.exp(torch.clamp_max(delta, 0.0)))
        rho = st.rho + torch.where(div_leaf[:, None], torch.zeros_like(r), r)
        r_first = r if n == 0 else st.r_first
        new_lsw = torch.logaddexp(st.lsw, lw)
        take = live & ~div_leaf & (leaf_logu[:, n] < lw - new_lsw)
        if n % 2 == 0:
            slot = min(bin(n).count("1"), max_depth - 1)
            rows = torch.stack([r, rho, st.r], dim=1)
            ckpt[:, slot] = keep(live, rows, ckpt[:, slot])
            turning = torch.zeros_like(st.turning)
        else:
            idx_max = bin(n).count("1") - 1
            idx_min = idx_max - ((n + 1) & -(n + 1)).bit_length() + 2
            turning = ~div_leaf & _old_uturn_check(metric, r, rho, ckpt, idx_min, idx_max)
        st = Subtree(
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


# ---------------------------------------------------------------------------
# targets and injected randomness


def _gaussian(d, dev, dtype, seed=0, lo=0.1, hi=10.0):
    """An anisotropic Gaussian's value-and-grad and its scales, ``lo`` to
    ``hi`` in a shuffled order."""
    scale = np.geomspace(lo, hi, d)[np.random.default_rng(seed).permutation(d)]
    scale = torch.as_tensor(scale, dtype=dtype, device=dev)

    def vag(q):
        return -0.5 * torch.sum((q / scale) ** 2, dim=-1), -q / scale ** 2

    return vag, scale


def _rand(c, d, max_depth, dev, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"r0_z": torch.randn(c, d, generator=g, device=dev, dtype=dtype),
            "go_right": torch.rand(c, max_depth, generator=g, device=dev) < 0.5,
            "merge_logu": -torch.empty(c, max_depth, device=dev, dtype=dtype
                                       ).exponential_(generator=g),
            "leaf_logu": -torch.empty(c, max_depth, 1 << (max_depth - 1), device=dev,
                                      dtype=dtype).exponential_(generator=g)}


def _inv(c, d, shared, dev, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (d,) if shared else (c, d)
    return 0.5 + 1.5 * torch.rand(shape, generator=g, device=dev, dtype=dtype)


def _transitions(vag, metric, eps, q, k, max_depth, dev, seed):
    """``k`` transitions under injected randomness: a list of (q, logp,
    grad, stats) and the syncs."""
    c, d = q.shape
    syncs = HostSyncs()
    logp, grad = vag(q)
    out = []
    for i in range(k):
        rand = _rand(c, d, max_depth, dev, q.dtype, seed + i)
        q, logp, grad, stats = nuts_transition(vag, metric, eps, q, logp, grad, max_depth,
                                               rand=rand, syncs=syncs)
        out.append((q, logp, grad, stats))
    return out, syncs


# ---------------------------------------------------------------------------
# on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
def test_plain_leaf_equals_the_old_eager_tree_bit_for_bit(monkeypatch, dtype, shared):
    c, d, max_depth = 12, 5, 6
    vag, _ = _gaussian(d, "cpu", dtype, lo=0.5, hi=2.0)
    metric = make_metric(_inv(c, d, shared, "cpu", dtype, 1))
    eps = torch.linspace(0.1, 1.5, c, dtype=dtype)  # the widest steps diverge
    q0 = torch.randn(c, d, generator=torch.Generator().manual_seed(2), dtype=dtype)
    new, syncs_new = _transitions(vag, metric, eps, q0, 6, max_depth, "cpu", 10)
    monkeypatch.setattr(tree, "_build_subtree", _old_build_subtree)
    old, syncs_old = _transitions(vag, metric, eps, q0, 6, max_depth, "cpu", 10)
    for a, b in zip(new, old):
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x, y)
        assert all(torch.equal(a[3][k], b[3][k]) for k in b[3])
    assert syncs_new.count == syncs_old.count
    assert sum(bool(s["diverging"].any()) for *_, s in new) > 0
    assert max(int(s["depth"].max()) for *_, s in new) >= 3


def test_dispatch_takes_the_plain_leaf_on_the_cpu_and_for_a_dense_metric():
    c, d = 6, 3
    vag, _ = _gaussian(d, "cpu", torch.float32)
    q0 = torch.randn(c, d, generator=torch.Generator().manual_seed(0))
    eps = torch.full((c,), 0.5)
    diag = make_metric(torch.ones(c, d))
    dense = make_metric(torch.eye(d).expand(c, d, d).clone(), dense=True)
    for metric in (diag, dense):
        _, syncs = _transitions(vag, metric, eps, q0, 3, 5, "cpu", 0)
        assert syncs.leaf_kernel == 0 and syncs.count > 0
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert leaf.uses_kernel(on_card, diag)
    assert not leaf.uses_kernel(on_card, dense) and not leaf.uses_kernel(q0, diag)
    args = (eps[:, None], q0, q0, q0, eps, torch.zeros(c, 4), torch.ones(c, dtype=torch.bool), 5)
    with pytest.raises(ValueError, match="CUDA"):
        LeafKernel(diag, *args)
    with pytest.raises(ValueError, match="diagonal"):
        LeafKernel(dense, *args)


def test_a_cpu_run_counts_no_kernel_leaf():
    smp = NUTSSampler(model=compile_logp(bench.eight_schools_ir(), device="cpu"),
                      num_warmup=20, num_samples=10)
    _, stats = smp.run(num_chains=4, seed=1)
    assert stats["leaf_kernel_leaves"] == smp.last_run["leaf_kernel_leaves"] == 0
    assert stats["vag_calls"]["leaf"] > 0


def test_the_flag_read_is_one_host_sync():
    syncs = HostSyncs()
    assert syncs.flag(torch.tensor(1, dtype=torch.int32))
    assert not syncs.flag(torch.tensor([0], dtype=torch.int32))
    assert syncs.count == 2
    with profiling.tracing(True):
        with profiling.fit_spans() as spans:
            syncs.flag(torch.tensor(3, dtype=torch.int32))
            syncs.any(torch.tensor([False, True]))
    assert syncs.count == 4 and spans["exmc.sync"]["count"] == 2


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


LEAF_SHAPES = [(1024, 10), (64, 55), (16, 2), (3, 1), (8, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,d", LEAF_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
def test_one_leaf_of_the_kernel_against_the_plain_leaf_on_card(c, d, dtype, shared):
    """Leaves 0..7 of one subtree (odd leaves check 1, 2 and 3 slots),
    each from the kernel's state before it, by the kernel and by the plain
    leaf. The fields no dot product feeds are bit-equal, the masks and
    counts equal; joint, lsw and accept, after the kinetic energy's sum
    of d products taken in another order, lie within 4 d ulps of the
    magnitudes it adds: 4 d eps (1 + |joint0| + |joint| + KE)."""
    dev = _card()
    max_depth = 5
    vag, scale = _gaussian(d, dev, dtype, seed=c, lo=0.5, hi=2.0)
    metric = make_metric(_inv(c, d, shared, dev, dtype, 3))
    g = torch.Generator(device=dev).manual_seed(c + d)
    z0 = torch.randn(c, d, generator=g, device=dev, dtype=dtype) * scale
    r0 = torch.randn(c, d, generator=g, device=dev, dtype=dtype) / metric.chol_inv
    logp0, g0 = vag(z0)
    joint0 = logp0 - kinetic_energy(metric, r0)
    step = 0.3 + 0.9 * torch.rand(c, generator=g, device=dev, dtype=dtype)
    step = torch.where(torch.arange(c, device=dev) % 7 == 3, 8.0 * step, step)  # diverge
    sign = torch.where(torch.rand(c, generator=g, device=dev) < 0.5, 1.0, -1.0).to(dtype)
    eps_signed = (step * sign * float(scale.min()))[:, None]
    active = torch.rand(c, generator=g, device=dev) < 0.9
    leaf_logu = -torch.empty(c, 8, device=dev, dtype=dtype).exponential_(generator=g)
    k = LeafKernel(metric, eps_signed, z0, r0, g0, joint0, leaf_logu, active, max_depth)
    tol = 4 * d * torch.finfo(dtype).eps
    seen = {"turning": 0, "diverging": 0, "take": 0}
    for n in range(8):
        st = Subtree(*(t.clone() for t in k.subtree()))
        ckpt, live = k.ckpt.clone(), k.live.clone()
        inputs = []

        def vag_rec(q):
            inputs.append(q.clone())
            return vag(q)

        want = leaf.leaf_plain(vag_rec, metric, eps_signed, n, st, joint0, leaf_logu[:, n],
                               live, ckpt, max_depth)
        _same(k.z_in, inputs[0])
        k.step(n, *vag(k.z_in), has_next=n < 7)
        got = k.subtree()
        for name in ("n", "z", "r", "g", "r_first", "z_prop", "logp_prop", "g_prop", "rho",
                     "turning", "diverging"):
            _same(getattr(got, name), getattr(want, name))
        _same(k.ckpt, ckpt)
        _same(k.live, active & ~want.turning & ~want.diverging)
        assert bool(k.live_flag(n)) == bool((k.live).any())
        ke = kinetic_energy(metric, want.r).abs()
        bound = tol * (1 + joint0.abs() + want.joint_prop.abs() + ke)
        for name in ("joint_prop", "lsw"):
            a, b = getattr(got, name), getattr(want, name)
            finite = torch.isfinite(b)
            assert torch.equal(finite, torch.isfinite(a))
            assert ((a - b).abs()[finite] <= bound[finite]).all(), name
        assert ((got.sum_accept - want.sum_accept).abs() <= (n + 1) * bound).all()
        seen["turning"] += int((want.turning & live).sum())
        seen["diverging"] += int((want.diverging & live).sum())
        seen["take"] += int((want.logp_prop != st.logp_prop).sum())
    if c >= 16:
        assert min(seen.values()) > 0, seen


def _run_pair(monkeypatch, vag, metric, eps, q0, k, max_depth, seed):
    kernel, syncs = _transitions(vag, metric, eps, q0, k, max_depth, "cuda", seed)
    assert syncs.leaf_kernel > 0
    again, _ = _transitions(vag, metric, eps, q0, k, max_depth, "cuda", seed)
    with monkeypatch.context() as m:
        m.setattr(leaf, "uses_kernel", lambda z, metric: False)
        plain, syncs_plain = _transitions(vag, metric, eps, q0, k, max_depth, "cuda", seed)
    assert syncs_plain.leaf_kernel == 0
    for a, b in zip(kernel, again):
        assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
        assert all(torch.equal(a[3][s], b[3][s]) for s in a[3])
    for i, (a, b) in enumerate(zip(kernel, plain)):
        for s in ("depth", "n_steps", "diverging"):
            assert torch.equal(a[3][s], b[3][s]), (i, s)
        torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=0)
        torch.testing.assert_close(a[1], b[1], rtol=1e-5, atol=0)
    return kernel


@pytest.mark.gpu
def test_eight_schools_transitions_kernel_against_plain_on_card(monkeypatch):
    dev = _card()
    model = compile_logp(bench.eight_schools_ir(), device=dev)
    c, d = 128, model.size
    q0 = torch.randn(c, d, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    metric = make_metric(_inv(c, d, False, dev, torch.float32, 6))
    eps = torch.full((c,), 0.35, device=dev)
    out = _run_pair(monkeypatch, model.value_and_grad, metric, eps, q0, 200, 8, 1000)
    assert max(int(s["depth"].max()) for *_, s in out) >= 3


@pytest.mark.gpu
def test_gaussian_transitions_kernel_against_plain_on_card(monkeypatch):
    dev = _card()
    c, d = 64, 40
    vag, scale = _gaussian(d, dev, torch.float32, seed=7, lo=0.3, hi=3.0)
    q0 = torch.randn(c, d, generator=torch.Generator(device=dev).manual_seed(8),
                     device=dev) * scale
    metric = make_metric(torch.ones(d, device=dev))
    eps = torch.full((c,), 0.2, device=dev)
    out = _run_pair(monkeypatch, vag, metric, eps, q0, 200, 7, 2000)
    assert max(int(s["depth"].max()) for *_, s in out) >= 4


@pytest.mark.gpu
def test_a_run_counts_every_leaf_through_the_kernel_on_card():
    dev = _card()
    model = compile_logp(bench.eight_schools_ir(), device=dev)
    smp = NUTSSampler(model=model, num_warmup=40, num_samples=20)
    _, stats = smp.run(num_chains=64, seed=2)
    assert stats["leaf_kernel_leaves"] == stats["vag_calls"]["leaf"] > 0
    assert smp.last_run["leaf_kernel_leaves"] == stats["leaf_kernel_leaves"]
    dense = NUTSSampler(model=model, num_warmup=20, num_samples=10, dense_mass=True)
    _, stats = dense.run(num_chains=8, seed=2)
    assert stats["leaf_kernel_leaves"] == 0 and stats["vag_calls"]["leaf"] > 0
