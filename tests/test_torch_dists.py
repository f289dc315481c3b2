"""The port's distributions against the JAX package's on the same numpy
inputs: every registered distribution's logpdf and its gradients in the
value and the parameters, ``log_survival``/``log_cdf``, the censored
likelihoods, edges (boundaries, deep tails, large counts, the mixture's
logsumexp), the registry itself and the samplers' generator discipline.

Tolerance: float32 on both sides, 1e-5 relative on top of 1e-5
absolute unless a case states its own."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu.dists.composite import CENSORED as JCENSORED
from exmc_tpu_torch.dists.composite import CENSORED as TCENSORED

C, N = 5, 7


def _f32(a):
    return np.asarray(a, np.float32)


def _check(jfn, tfn, arrays, rtol=1e-5, atol=1e-5, grad=True):
    """jfn(*jnp arrays) and tfn(*torch tensors) give the same values, and
    the same gradients of their sum in every input."""
    arrays = [_f32(a) for a in arrays]
    ref = np.asarray(jfn(*[jnp.asarray(a) for a in arrays]))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    got = tfn(*ts)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=rtol, atol=atol)
    if not grad:
        return
    jg = jax.grad(lambda *xs: jnp.sum(jfn(*xs)),
                  argnums=tuple(range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    tg = (torch.autograd.grad(got.sum(), ts, allow_unused=True)
          if got.requires_grad else [None] * len(ts))
    for i, (g, w) in enumerate(zip(tg, jg)):
        g = np.zeros_like(arrays[i]) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"gradient of input {i}")


def _elementwise(name, params, x, method="logpdf", **kw):
    """An elementwise dist: value (C, N), params (C, 1) per chain."""
    keys = list(params)
    jd, td = getattr(exmc_tpu.dists, name), getattr(exmc_tpu_torch.dists, name)

    def jfn(x, *ps):
        return getattr(jd, method)(x, dict(zip(keys, ps)))

    def tfn(x, *ps):
        return getattr(td, method)(x, dict(zip(keys, ps)))

    _check(jfn, tfn, [x] + [params[k] for k in keys], **kw)


def _per_chain(c, v, lo, hi, seed):
    return (v * np.random.default_rng(seed).uniform(lo, hi, size=(c, 1)))


RNG = np.random.default_rng(0)
POS = RNG.uniform(0.05, 6.0, size=(C, N))
REAL = RNG.uniform(-5.0, 5.0, size=(C, N))
UNIT = RNG.uniform(0.02, 0.98, size=(C, N))
COUNTS = RNG.integers(0, 12, size=(C, N)).astype(float)
BITS = (RNG.uniform(size=(C, N)) < 0.5).astype(float)

# (dist, {param: per-chain base value}, value array)
ELEMENTWISE = [
    ("Normal", {"mu": 0.4, "sigma": 1.3}, REAL),
    ("Flat", {}, REAL),
    ("HalfNormal", {"sigma": 1.7}, POS),
    ("Exponential", {"lambda": 0.7}, POS),
    ("Gamma", {"alpha": 2.5, "beta": 1.5}, POS),
    ("Gamma", {"alpha": 0.4, "beta": 0.3}, POS),
    ("Beta", {"alpha": 2.0, "beta": 3.0}, UNIT),
    ("Beta", {"alpha": 0.6, "beta": 0.7}, UNIT),
    ("Uniform01", {}, UNIT),
    ("Uniform", {"lower": -7.0, "upper": 8.0}, REAL),
    ("StudentT", {"df": 3.0, "loc": 0.3, "scale": 1.7}, REAL),
    ("Cauchy", {"loc": -0.5, "scale": 0.8}, REAL),
    ("HalfCauchy", {"scale": 2.0}, POS),
    ("LogNormal", {"mu": 0.3, "sigma": 0.8}, POS),
    ("Laplace", {"mu": 0.2, "b": 1.4}, REAL),
    ("TruncatedNormal", {"mu": 0.5, "sigma": 1.2, "lower": -6.0, "upper": 7.0}, REAL),
    ("Weibull", {"k": 1.5, "lambda": 2.0}, POS),
    ("InverseGamma", {"alpha": 3.0, "beta": 4.0}, POS),
    ("Gumbel", {"loc": 0.8, "scale": 1.3}, REAL),
    ("Bernoulli", {"logits": 1.3}, BITS),
    ("Bernoulli", {"p": 0.3}, BITS),
    ("Poisson", {"mu": 3.5}, COUNTS),
    ("Binomial", {"n": 20.0, "p": 0.35}, COUNTS),
    ("Binomial", {"n": 20.0, "logits": -0.4}, COUNTS),
    ("NegativeBinomial", {"mu": 4.0, "alpha": 3.0}, COUNTS),
    ("BetaBinomial", {"n": 20.0, "alpha": 2.0, "beta": 3.0}, COUNTS),
]


@pytest.mark.parametrize(
    "name,params,x", ELEMENTWISE,
    ids=[f"{c[0]}-{'-'.join(c[1])}" for c in ELEMENTWISE])
def test_elementwise_logpdf_and_grad(name, params, x):
    """logpdf and its gradient in the value and every parameter, with
    the parameters varying per chain as referenced RVs give them."""
    pv = {k: _per_chain(C, v, 0.7, 1.3, i) for i, (k, v) in enumerate(params.items())}
    _elementwise(name, pv, x)


@pytest.mark.parametrize("method", ["log_survival", "log_cdf"])
def test_weibull_survival_and_cdf(method):
    pv = {"k": _per_chain(C, 1.5, 0.6, 1.4, 1), "lambda": _per_chain(C, 2.0, 0.5, 1.5, 2)}
    _elementwise("Weibull", pv, POS, method=method)


def test_truncated_normal_deep_tail():
    """A window 5-9 sd above the mean: the normalization is a difference
    of ndtr values near 1, kept exact by the erf/erfc ndtr; the DESIGN
    value -0.5373 (not the reference doctest's -0.2676) is the JAX
    package's."""
    x = np.linspace(5.1, 8.9, N)[None].repeat(C, 0)
    pv = {"mu": np.zeros((C, 1)), "sigma": _per_chain(C, 1.0, 0.95, 1.05, 3),
          "lower": np.full((C, 1), 5.0), "upper": np.full((C, 1), 9.0)}
    _elementwise("TruncatedNormal", pv, x, rtol=2e-5, atol=2e-4)
    doc = {"mu": 0.0, "sigma": 1.0, "lower": -1.0, "upper": 1.0}
    got = exmc_tpu_torch.dists.TruncatedNormal.logpdf(
        torch.tensor(0.0), {k: torch.tensor(v) for k, v in doc.items()})
    ref = exmc_tpu.dists.TruncatedNormal.logpdf(0.0, doc)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(got), -0.5373, atol=1e-4)


@pytest.mark.parametrize("name,params,x", [
    ("Poisson", {"mu": 9.0e4}, np.full((C, N), 9.0e4) + np.arange(N)),
    ("Binomial", {"n": 1.0e6, "p": 0.4}, np.full((C, N), 4.0e5) + np.arange(N)),
    ("NegativeBinomial", {"mu": 5.0e4, "alpha": 30.0}, np.full((C, N), 5.0e4) + np.arange(N)),
    ("BetaBinomial", {"n": 2.0e5, "alpha": 20.0, "beta": 30.0},
     np.full((C, N), 8.0e4) + np.arange(N)),
])
def test_large_counts(name, params, x):
    """lgamma-based pmfs at counts of 1e4-1e6: the log-densities are
    differences of lgamma values near 1e6-1e7, which each library rounds
    to its own float32 ulp, so the tolerance is 4 ulp of the largest
    lgamma term."""
    pv = {k: _per_chain(C, v, 0.999, 1.001, 7) for k, v in params.items()}
    big = float(np.max([x.max(), *[np.max(v) for v in pv.values()]]))
    ulp = float(np.spacing(np.float32(big * np.log(big))))
    _elementwise(name, pv, x, rtol=1e-5, atol=4 * ulp)


def test_boundaries_give_the_jax_values():
    """Values on a support boundary: the same -inf/finite results (1e-6
    absolute: JAX's float32 lgamma(1) is -4.8e-7, torch's is 0)."""
    cases = [("Beta", {"alpha": 2.0, "beta": 3.0}, [0.0, 1.0]),
             ("Gamma", {"alpha": 2.0, "beta": 1.0}, [0.0]),
             ("Exponential", {"lambda": 1.5}, [0.0]),
             ("Bernoulli", {"p": 0.0}, [0.0, 1.0]),
             ("Bernoulli", {"p": 1.0}, [0.0, 1.0]),
             ("Poisson", {"mu": 0.0}, [0.0, 3.0])]
    for name, params, xs in cases:
        jd, td = getattr(exmc_tpu.dists, name), getattr(exmc_tpu_torch.dists, name)
        x = _f32(xs)
        ref = np.asarray(jd.logpdf(jnp.asarray(x), {k: jnp.float32(v) for k, v in params.items()}))
        got = td.logpdf(torch.as_tensor(x), {k: torch.tensor(v) for k, v in params.items()})
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_gaussian_random_walk_per_chain():
    x = np.random.default_rng(4).normal(size=(C, 30)).cumsum(-1)
    sig = _per_chain(C, 1.0, 0.3, 2.0, 5)
    jd = exmc_tpu.dists.GaussianRandomWalk
    # 30-term sums with cancellation in the sigma gradient: 5e-5 absolute
    _check(jax.vmap(lambda xx, s: jd.logpdf(xx, {"sigma": s[0]})),
           lambda xx, s: exmc_tpu_torch.dists.GaussianRandomWalk.logpdf(xx, {"sigma": s}),
           [x, sig], atol=5e-5)


@pytest.mark.parametrize("key", ["p", "logits"])
def test_categorical(key):
    """p (C, 1, K) per chain against integer-coded y (1, n)."""
    rng = np.random.default_rng(6)
    k = 4
    raw = rng.dirichlet(np.ones(k), size=C) if key == "p" else rng.normal(size=(C, k))
    y = rng.integers(0, k, size=(1, 9)).astype(float)
    jd = exmc_tpu.dists.Categorical
    _check(jax.vmap(lambda pp, yy: jd.logpdf(yy, {key: pp}), in_axes=(0, None)),
           lambda pp, yy: exmc_tpu_torch.dists.Categorical.logpdf(yy, {key: pp[:, None]}),
           [raw, y[0]], )


def test_ordered_logistic():
    """eta (C, n) against cutpoints (C, 1, K-1) per chain, y (1, n); the
    extreme etas run the log-sigmoid ladder's clamp."""
    rng = np.random.default_rng(8)
    n = 9
    eta = rng.normal(size=(C, n)) * 3.0
    eta[0, 0], eta[1, 1] = 40.0, -40.0
    cut = np.sort(rng.normal(size=(C, 3)), axis=-1)
    y = rng.integers(0, 4, size=n).astype(float)
    jd = exmc_tpu.dists.OrderedLogistic
    _check(jax.vmap(lambda e, c, yy: jd.logpdf(yy, {"eta": e, "cutpoints": c}),
                    in_axes=(0, 0, None)),
           lambda e, c, yy: exmc_tpu_torch.dists.OrderedLogistic.logpdf(
               yy[None], {"eta": e, "cutpoints": c[:, None]}),
           [eta, cut, y], atol=2e-5)


def _spd(d, seed):
    a = np.random.default_rng(seed).normal(size=(d, d))
    return a @ a.T / d + np.eye(d)


def test_mv_normal_constant_cov_and_batched_chol():
    """A constant covariance factored once (prepare_params) against rows
    (C, n, d); and a per-chain Cholesky factor (a sampled LKJ)."""
    rng = np.random.default_rng(9)
    d = 3
    cov = _spd(d, 10)
    x = rng.normal(size=(C, 4, d))
    mu = rng.normal(size=(C, d))
    jd, td = exmc_tpu.dists.MvNormal, exmc_tpu_torch.dists.MvNormal
    _check(jax.vmap(lambda xx, m: jd.logpdf(xx, {"mu": m, "cov": jnp.asarray(_f32(cov))})),
           lambda xx, m: td.logpdf(xx, td.prepare_params(
               {"mu": m[:, None], "cov": torch.as_tensor(_f32(cov))[None, None]})),
           [x, mu])
    chols = np.stack([np.linalg.cholesky(_spd(d, 20 + i)) for i in range(C)])
    _check(jax.vmap(lambda xx, m, ch: jd.logpdf(xx, {"mu": m, "chol": ch})),
           lambda xx, m, ch: td.logpdf(xx, {"mu": m, "chol": ch}),
           [x[:, 0], mu, chols])


def test_dirichlet_multinomial_zero_sum_lkj():
    rng = np.random.default_rng(11)
    k = 4
    w = rng.dirichlet(np.ones(k), size=C)
    alpha = rng.uniform(0.5, 3.0, size=(C, k))
    jdir, tdir = exmc_tpu.dists.Dirichlet, exmc_tpu_torch.dists.Dirichlet
    _check(jax.vmap(lambda x, a: jdir.logpdf(x, {"alpha": a})),
           lambda x, a: tdir.logpdf(x, {"alpha": a}), [w, alpha])
    counts = rng.multinomial(50, np.ones(k) / k, size=1).astype(float)
    jm, tm = exmc_tpu.dists.Multinomial, exmc_tpu_torch.dists.Multinomial
    _check(jax.vmap(lambda p, y: jm.logpdf(y, {"p": p}), in_axes=(0, None)),
           lambda p, y: tm.logpdf(y[None], {"p": p}), [w, counts[0]])
    x = rng.normal(size=(C, k))
    x -= x.mean(-1, keepdims=True)
    sig = rng.uniform(0.5, 2.0, size=C)
    jz, tz = exmc_tpu.dists.ZeroSumNormal, exmc_tpu_torch.dists.ZeroSumNormal
    _check(jax.vmap(lambda xx, s: jz.logpdf(xx, {"sigma": s})),
           lambda xx, s: tz.logpdf(xx, {"sigma": s}), [x, sig])
    from exmc_tpu.transforms import CHOLESKY_CORR
    L = np.asarray(jax.vmap(CHOLESKY_CORR.forward)(jnp.asarray(_f32(rng.normal(size=(C, 3))))))
    jl, tl = exmc_tpu.dists.LKJCholesky, exmc_tpu_torch.dists.LKJCholesky
    _check(jax.vmap(lambda ll: jl.logpdf(ll, {"eta": 2.0})),
           lambda ll: tl.logpdf(ll, {"eta": torch.tensor(2.0)}), [L])
    with pytest.raises(ValueError, match="fixed constant"):
        tl.validate_ir_params({"eta": "e"})


def test_mixture_logsumexp_far_components():
    """Components 60 sd apart: the logsumexp keeps the far component's
    tiny weight without underflow, and the gradient reaches the mean."""
    x = np.concatenate([np.linspace(-3, -1, 4), np.linspace(58, 62, 4)])
    m1 = _per_chain(C, 60.0, 0.99, 1.01, 12)
    comps = [exmc_tpu.dists.Normal, exmc_tpu.dists.Normal]
    tcomps = [exmc_tpu_torch.dists.Normal, exmc_tpu_torch.dists.Normal]
    w = np.array([0.999, 0.001])

    def jfn(xx, m):
        return jax.vmap(lambda mm: exmc_tpu.dists.Mixture.logpdf(xx, {
            "components": comps, "weights": jnp.asarray(_f32(w)),
            "params": [{"mu": -2.0, "sigma": 0.5}, {"mu": mm[0], "sigma": 0.5}]}))(m)

    def tfn(xx, m):
        return exmc_tpu_torch.dists.Mixture.logpdf(xx[None], {
            "components": tcomps, "weights": torch.as_tensor(_f32(w))[None],
            "params": [{"mu": torch.tensor(-2.0), "sigma": torch.tensor(0.5)},
                       {"mu": m, "sigma": torch.tensor(0.5)}]})

    _check(jfn, tfn, [x, m1], atol=1e-4)


@pytest.mark.parametrize("kind", ["right", "left", "interval"])
@pytest.mark.parametrize("dist", ["Normal", "Weibull"])
def test_censored_likelihoods(kind, dist):
    """Censored observations through the base dist's log_survival/log_cdf
    (Weibull) or log_ndtr (Normal), including values 30 sd into a tail
    for right/left censoring (1e-4 relative: the two libraries'
    log_ndtr asymptotic series differ by 5e-5 in the gradient there).
    Interval windows stay where float32 resolves CDF(b) - CDF(a)."""
    rng = np.random.default_rng(13)
    if dist == "Normal":
        params = {"mu": _per_chain(C, 1.0, 0.5, 1.5, 1), "sigma": _per_chain(C, 1.0, 0.8, 1.2, 2)}
        v = np.concatenate([rng.normal(size=N - 2), [31.0, -31.0]])
    else:
        params = {"k": _per_chain(C, 1.5, 0.8, 1.2, 1), "lambda": _per_chain(C, 2.0, 0.8, 1.2, 2)}
        v = np.concatenate([rng.uniform(0.1, 4.0, size=N - 1),
                            [4.5 if kind == "interval" else 25.0]])
    keys = list(params)
    jd, td = getattr(exmc_tpu.dists, dist), getattr(exmc_tpu_torch.dists, dist)
    if kind == "interval":
        if dist == "Normal":
            v[-2:] = [2.5, -2.5]
        lo = v - np.abs(rng.normal(size=v.shape)) - 0.1
        if dist == "Weibull":
            lo = np.maximum(lo, 0.01)

        def jfn(a, b, *ps):
            return JCENSORED.log_likelihood(kind, {"lower": a, "upper": b}, jd, dict(zip(keys, ps)))

        def tfn(a, b, *ps):
            return TCENSORED.log_likelihood(kind, {"lower": a, "upper": b}, td, dict(zip(keys, ps)))

        _check(jfn, tfn, [lo[None], v[None]] + [params[k] for k in keys], rtol=2e-5, atol=2e-4)
        return

    def jfn(x, *ps):
        return JCENSORED.log_likelihood(kind, x, jd, dict(zip(keys, ps)))

    def tfn(x, *ps):
        return TCENSORED.log_likelihood(kind, x, td, dict(zip(keys, ps)))

    _check(jfn, tfn, [v[None]] + [params[k] for k in keys], rtol=1e-4, atol=1e-4)


def test_custom_dist_takes_a_torch_callable_and_data():
    seen = {}

    def lp(x, params, data=None):
        seen["data"] = data
        return -0.5 * (x - params["loc"]) ** 2

    dist = exmc_tpu_torch.dists.Custom(logpdf_fn=lp, transform="log")
    x = torch.linspace(-1, 1, 5)
    out = dist.logpdf(x, {"loc": torch.tensor(0.5), "__data__": "D"})
    np.testing.assert_allclose(out.numpy(), (-0.5 * (x - 0.5) ** 2).numpy())
    assert seen["data"] == "D" and dist.default_transform({}) == "log"


def test_registry_equals_jax():
    """The port registers the JAX package's 32 distributions under the
    same names, plus the Custom class."""
    assert sorted(exmc_tpu_torch.dists.all_dists()) == sorted(exmc_tpu.dists.all_dists())
    assert len(exmc_tpu_torch.dists.all_dists()) == 32
    for name in exmc_tpu.dists.__all__:
        assert hasattr(exmc_tpu_torch.dists, name), name
    for name, d in exmc_tpu.dists.all_dists().items():
        t = exmc_tpu_torch.dists.get(name)
        assert t.name == name and t.value_event_dims in (0, 1, 2)
        if name not in ("uniform", "mixture"):
            assert t.default_transform({}) == d.default_transform({}), name


@pytest.mark.parametrize("name,params,mean,sd", [
    ("Gamma", {"alpha": 2.5, "beta": 2.0}, 1.25, np.sqrt(2.5) / 2.0),
    ("Gamma", {"alpha": 0.5, "beta": 1.0}, 0.5, np.sqrt(0.5)),
    ("Beta", {"alpha": 2.0, "beta": 3.0}, 0.4, 0.2),
    ("InverseGamma", {"alpha": 5.0, "beta": 4.0}, 1.0, 1.0 / np.sqrt(3.0)),
    ("TruncatedNormal", {"mu": 0.0, "sigma": 1.0, "lower": 0.0, "upper": 50.0},
     np.sqrt(2 / np.pi), np.sqrt(1 - 2 / np.pi)),
    ("Laplace", {"mu": 1.0, "b": 2.0}, 1.0, 2.0 * np.sqrt(2.0)),
    ("Gumbel", {"loc": 0.0, "scale": 1.0}, 0.5772156649, np.pi / np.sqrt(6.0)),
    ("Poisson", {"mu": 3.5}, 3.5, np.sqrt(3.5)),
    ("Binomial", {"n": 20.0, "p": 0.3}, 6.0, np.sqrt(4.2)),
    ("NegativeBinomial", {"mu": 4.0, "alpha": 3.0}, 4.0, np.sqrt(4.0 + 16.0 / 3.0)),
])
def test_samplers_use_the_generator_and_match_moments(name, params, mean, sd):
    """Draws come from the explicit generator (same seed, same draws)
    with the right first two moments (5 standard errors)."""
    d = getattr(exmc_tpu_torch.dists, name)
    n = 100_000
    a = d.sample(params, (n,), torch.Generator().manual_seed(0))
    b = d.sample(params, (n,), torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(float(a.double().mean()) - mean) < 5 * sd / np.sqrt(n)
    assert abs(float(a.double().std()) - sd) < 0.03 * sd


def test_multivariate_samplers():
    g = torch.Generator().manual_seed(1)
    w = exmc_tpu_torch.dists.Dirichlet.sample({"alpha": np.array([2.0, 3.0, 5.0])},
                                              (20000, 3), g)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(w.mean(0).numpy(), [0.2, 0.3, 0.5], atol=0.01)
    y = exmc_tpu_torch.dists.Multinomial.sample({"n": 30.0, "p": torch.tensor([0.2, 0.3, 0.5])},
                                                (20000, 3), g)
    assert (y.sum(-1) == 30).all()
    np.testing.assert_allclose(y.mean(0).numpy(), [6.0, 9.0, 15.0], atol=0.15)
    L = exmc_tpu_torch.dists.LKJCholesky.sample({"eta": 2.0}, (20000, 3, 3), g)
    r = (L[:, 1] * L[:, 0]).sum(-1)
    np.testing.assert_allclose([float(r.mean()), float(r.std())], [0.0, 1 / np.sqrt(6.0)],
                               atol=0.02)
    z = exmc_tpu_torch.dists.ZeroSumNormal.sample({"sigma": 2.0}, (20000, 4), g)
    np.testing.assert_allclose(z.sum(-1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(float(z.std(0).mean()), 2.0 * np.sqrt(0.75), rtol=0.03)


@pytest.mark.parametrize("name,lo,hi", [
    ("log_normal_cdf", -40.0, 10.0), ("log_normal_sf", -10.0, 40.0),
    ("normal_cdf", -8.0, 8.0), ("log1mexp", -6.0, -1e-3), ("logit", 0.01, 0.99),
    ("inv_softplus", 0.01, 8.0), ("softplus", -20.0, 20.0)])
def test_math_helpers_match_jax(name, lo, hi):
    """The special functions the dists and transforms use, value and
    gradient, over their working range (log1mexp on both sides of its
    -log 2 branch). log_ndtr's float32 gradient 30-40 sd into the tail is
    off its float64 value by up to 9e-5 (torch) and 5e-5 (JAX), so the
    two may differ by 1.2e-4 there: 2e-4 relative for those two."""
    from exmc_tpu import math as jm
    from exmc_tpu_torch import math as tm
    x = np.linspace(lo, hi, 301)[None]
    rtol = 2e-4 if name.startswith("log_normal") else 2e-5
    _check(getattr(jm, name), getattr(tm, name), [x], rtol=rtol, atol=1e-5)


def test_lbeta_matches_jax():
    from exmc_tpu import math as jm
    from exmc_tpu_torch import math as tm
    rng = np.random.default_rng(14)
    _check(jm.lbeta, tm.lbeta, [rng.uniform(0.1, 50.0, (C, N)), rng.uniform(0.1, 50.0, (C, N))],
           rtol=2e-5, atol=2e-5)
