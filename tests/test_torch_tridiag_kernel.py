"""The tridiagonal factor-and-solve kernel (``ops.tridiag``): which calls
of the Laplace marginal it takes (CUDA float64 outside autograd and
``torch.func``) and which keep the plain doubling scans, on the CPU; the
kernel against the plain scans, in a CUDA graph, and inside the float64
marginal's value-and-grad, on the card (``-m gpu``)."""

import math

import numpy as np
import pytest
import torch

from exmc_tpu_torch import marginal
from exmc_tpu_torch.ops import tridiag


def _system(batch, t, dtype=torch.float64, device="cpu", seed=0):
    """An SPD tridiagonal (a (*batch, T), b (*batch, 1)) shaped like the
    GRW marginal's Q + W, and a right-hand side."""
    gen = torch.Generator().manual_seed(seed)
    sigma = 0.005 + 0.2 * torch.rand(*batch, 1, generator=gen, dtype=torch.float64)
    w = 1e-3 + 5.0 * torch.rand(*batch, t, generator=gen, dtype=torch.float64)
    a = torch.cat([torch.full((*batch, t - 1), 2.0, dtype=torch.float64),
                   torch.ones(*batch, 1, dtype=torch.float64)], dim=-1) / sigma ** 2 + w
    b = -1.0 / sigma ** 2
    rhs = torch.randn(*batch, t, generator=gen, dtype=torch.float64)
    return tuple(x.to(dtype=dtype, device=device) for x in (a, b, rhs))


def _plain(fn, *args):
    """``fn`` with the kernel switched off."""
    usable = tridiag.usable
    tridiag.usable = lambda *_: False
    try:
        return fn(*args)
    finally:
        tridiag.usable = usable


def test_the_plain_scans_serve_every_cpu_call():
    a, b, rhs = _system((3,), 64)
    assert not tridiag.usable(a, b)
    d, ell = marginal._thomas_factor(a, b)
    x = marginal._thomas_solve(d, ell, rhs)
    full = (torch.diag_embed(a) + torch.diag_embed(b.expand(3, 63), 1)
            + torch.diag_embed(b.expand(3, 63), -1))
    assert torch.allclose(full @ x.unsqueeze(-1), rhs.unsqueeze(-1), rtol=1e-9, atol=1e-9)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_calls_the_kernel_cannot_serve_are_refused_on_card():
    _card()
    a, b, _ = _system((2,), 16, device="cuda")
    assert tridiag.usable(a, b)
    assert not tridiag.usable(a.float(), b.float())
    assert not tridiag.usable(a[..., :1], b)
    assert not tridiag.usable(a.cpu(), b)
    leaf = a.clone().requires_grad_(True)
    assert not tridiag.usable(leaf, b)
    with torch.no_grad():
        assert tridiag.usable(leaf, b)
    seen = []
    torch.func.grad(lambda x: seen.append(tridiag.usable(x, b)) or x.sum())(a)
    assert seen == [False]


@pytest.mark.gpu
@pytest.mark.parametrize("batch,t", [((4,), 2), ((4,), 3), ((16,), 255), ((16,), 256),
                                     ((16,), 257), ((2, 3), 1000), ((), 5000), ((4,), 5000)])
def test_kernel_equals_the_plain_scans_on_card(batch, t):
    _card()
    a, b, rhs = _system(batch, t, device="cuda", seed=t)
    d, ell = marginal._thomas_factor(a, b)
    x = marginal._thomas_solve(d, ell, rhs)
    d0, ell0 = _plain(marginal._thomas_factor, a, b)
    x0 = _plain(marginal._thomas_solve, d0, ell0, rhs)
    assert d.shape == d0.shape and ell.shape == ell0.shape and x.shape == x0.shape
    # the factor's recurrence is well conditioned; the solution's forward
    # error is the systems' condition number (up to ~1e8 here) times
    # rounding, so the residual below is the tight check of the solve
    for got, want, tol in ((d, d0, 1e-12), (ell, ell0, 1e-12), (x, x0, 1e-7)):
        err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
        assert err < tol, err
    # the residual of the solve against the system itself
    res = a * x - rhs
    res[..., 1:] += b * x[..., :-1]
    res[..., :-1] += b * x[..., 1:]
    assert (res.abs().max() / (a.abs() * x.abs()).max()).item() < 1e-13


@pytest.mark.gpu
def test_kernel_replays_in_a_cuda_graph_bit_for_bit():
    _card()
    a, b, rhs = _system((8,), 5000, device="cuda", seed=1)
    eager = marginal._thomas_solve(*marginal._thomas_factor(a, b), rhs)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        marginal._thomas_solve(*marginal._thomas_factor(a, b), rhs)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = marginal._thomas_solve(*marginal._thomas_factor(a, b), rhs)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
def test_float64_marginal_with_the_kernel_equals_the_plain_scans_on_card():
    _card()
    from exmc_tpu_torch.benchmarks.suite import sv_model

    r = np.asarray(sv_model(t=5000, seed=7).nodes["r_obs"].op[2], np.float64)
    marg = marginal.make_grw_marginal(marginal._sv_loglik(r), len(r), newton_iters=15,
                                      dtype=torch.float64)

    def logz_and_grad():
        sig = torch.tensor([0.01, 0.02, 0.05, 0.1], device="cuda", requires_grad=True)
        nu = torch.tensor([4.0, 10.0, 20.0, 40.0], device="cuda", requires_grad=True)
        logz = marg(sig, {"nu": nu})[0]
        g = torch.autograd.grad(logz.sum(), [sig, nu])
        return logz.double(), torch.stack([sig * g[0], nu * g[1]]).double()

    lz, g = logz_and_grad()
    lz0, g0 = _plain(logz_and_grad)
    assert torch.isfinite(lz).all() and torch.isfinite(g).all()
    # the marginal hands float32 back: the two agree to its rounding
    assert ((lz - lz0).abs() / lz0.abs()).max().item() < 1e-6, (lz, lz0)
    assert ((g - g0).abs().max() / g0.abs().max()).item() < 1e-5, (g, g0)
    assert math.isfinite(lz.sum().item())
