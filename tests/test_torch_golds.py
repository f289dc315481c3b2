"""The JAX battery's 51 gold standards in the port against the JAX
package's (the five ``stan_*`` built through each package's own Stan
frontend): each port IR compiles on the CPU with the JAX gold's flat
size and layout; its log-density and gradient at 4 seeded flat points,
and its constrained values there, equal the JAX compiled gold's; its
targets and options equal the JAX module's (the eight stored as
constants included, ``stan_logistic_d21``'s Laplace + importance-sampling
target among them). Plus the battery's coverage of every distribution
and a short CPU run of the fast subset through the port's ``validate``.

Tolerance: logp and gradient within 2e-5 of max(1, |value|) per point
(float32 sums of up to 1000 terms in another order); constrained values
1e-5; targets 1e-9 relative (the same float64 code or its stored
output)."""

from functools import lru_cache

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from exmc_tpu import compiler as jcompiler
from exmc_tpu.benchmarks import validation as jvalidation
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch.benchmarks import gold_models as tgold
from exmc_tpu_torch.benchmarks import validation as tvalidation
from exmc_tpu_torch.dists.base import Distribution, all_dists

STAN = {"stan_eight_schools", "stan_uniform_normal", "stan_logistic_1d",
        "stan_eight_schools_ncp", "stan_logistic_d21"}
TMAKERS = {tvalidation.gold_name(m): m for m in tvalidation.all_gold_standards()}
JMAKERS = {m.__name__: m for m in jvalidation._all_gold_standards()}
NAMES = list(TMAKERS)


@lru_cache(maxsize=None)
def _golds(name):
    make = TMAKERS[name]
    return JMAKERS[make.__name__](), make()


@lru_cache(maxsize=None)
def _compiled(name):
    jg, tg = _golds(name)
    return (jcompiler.compile_logp(jg.ir, ncp=jg.ncp),
            tcompiler.compile_logp(tg.ir, ncp=tg.ncp, device="cpu"))


def test_the_port_has_the_46_non_stan_golds():
    """And the five Stan golds: all 51, in the JAX battery's order."""
    jnames = [m.__name__ for m in jvalidation._all_gold_standards()]
    assert len(jnames) == 51
    assert len(NAMES) == 51
    assert [TMAKERS[n].__name__ for n in NAMES] == jnames
    assert STAN <= set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_gold_matches_jax(name):
    jg, tg = _golds(name)
    jm, tm = _compiled(name)
    assert tm.size == jm.size
    assert [(e.id, e.offset, e.length, tuple(e.shape), tuple(e.ushape))
            for e in tm.pm.entries] == [
        (e.id, e.offset, e.length, tuple(e.shape), tuple(e.ushape)) for e in jm.pm.entries]
    x = np.random.default_rng(0).uniform(-2, 2, size=(4, tm.size)).astype(np.float32)
    jl, jgr = jax.vmap(jm.value_and_grad)(jnp.asarray(x))
    tl, tgr = tm.value_and_grad(torch.as_tensor(x))
    jl, jgr = np.asarray(jl), np.asarray(jgr)
    err_lp = np.abs(tl.numpy() - jl) / np.maximum(1.0, np.abs(jl))
    err_g = np.abs(tgr.numpy() - jgr) / np.maximum(1.0, np.abs(jgr).max(-1, keepdims=True))
    assert err_lp.max() <= 2e-5 and err_g.max() <= 2e-5, (err_lp.max(), err_g.max())
    jc = jax.vmap(lambda f: jcompiler.constrain_flat(jm.ir, jm.pm, f))(jnp.asarray(x))
    tc = tm.constrain(torch.as_tensor(x))
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # targets, options and derived quantities
    assert (tg.name, tg.ncp) == (jg.name, jg.ncp)
    assert tg.opts == jg.opts
    assert sorted(tg.ref_means) == sorted(jg.ref_means) == sorted(tg.ref_sds)
    for k in jg.ref_means:
        np.testing.assert_allclose(np.asarray(tg.ref_means[k], float),
                                   np.asarray(jg.ref_means[k], float), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(tg.ref_sds[k], float),
                                   np.asarray(jg.ref_sds[k], float), rtol=1e-9, atol=1e-12)
    assert sorted(tg.derived) == sorted(jg.derived)
    if tg.derived:
        trace = {k: np.asarray(v)[None].repeat(2, 0) for k, v in jc.items()}
        for k in tg.derived:
            np.testing.assert_allclose(tg.derived[k](trace), jg.derived[k](trace))


def test_heavy_targets_are_the_stored_ones():
    assert set(tgold.HEAVY_TARGETS) == {
        "radon_varying_intercept", "kidiq_regression", "crossed_random_effects_lmm",
        "avtest_binomial_glmm", "kilpisjarvi_real_regression", "kilpisjarvi_ordinal",
        "diabetes_real_logistic", "stan_logistic_d21"}


def test_battery_covers_every_distribution():
    """Every port distribution appears in at least one port gold (the
    JAX battery's coverage test, tests/test_validation_battery.py)."""
    used = set()

    def visit(x):
        if isinstance(x, Distribution):
            used.add(x.name)
        elif isinstance(x, (list, tuple)):
            for e in x:
                visit(e)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    for name in NAMES:
        for node in _golds(name)[1].ir.nodes.values():
            if node.op[0] == "rv":
                visit(node.op[1])
                visit(node.op[2])
            if node.op[0] == "obs" and node.op[3].get("censored"):
                used.add("censored")
    missing = set(all_dists()) - used
    assert not missing, f"dists not exercised by any gold standard: {missing}"


FAST_SUBSET = ["exponential_gamma", "uniform01_bernoulli", "mixture_loc",
               "censored_right_normal", "linreg_meas_obs_matmul", "mvn_dense_mass",
               "dirichlet_prior"]


def test_battery_fast_subset():
    """The JAX battery's fast subset (less its Stan gold) on the port's
    sampler on the CPU, 8 chains x 200+200, under the battery's own
    criterion."""
    n_pass, results = tvalidation.validate(num_warmup=200, num_samples=200,
                                           num_chains=8, models=FAST_SUBSET,
                                           verbose=False, device="cpu")
    failed = [r["model"] for r in results if not r["pass"]]
    assert n_pass == len(results) == len(FAST_SUBSET), f"failed: {failed}"
    for r in results:
        assert r["max_rhat"] < tvalidation.RHAT_MAX and r["gates_pass"], r["model"]


def test_recipe_scales_a_golds_own_iterations():
    grw = _golds("grw_kalman_t1000")[1]
    opts = tvalidation.sampler_opts(grw, 300, 300)
    assert (opts["num_warmup"], opts["num_samples"]) == (240, 240)
    assert tvalidation.sampler_opts(grw, 1000, 1000)["num_warmup"] == 800
    dense = _golds("mvn_dense_mass")[1]
    assert tvalidation.sampler_opts(dense, 300, 300) == {
        "dense_mass": True, "num_warmup": 300, "num_samples": 300}


@pytest.mark.parametrize("name", sorted(tvalidation.CARD_OVERRIDES))
def test_card_recipe_overrides(name):
    """An override names a gold and changes only how it is sampled; the
    card order keeps every gold once, the costed ones first."""
    over = tvalidation.CARD_OVERRIDES[name]
    assert name in NAMES
    assert tvalidation.card_recipe(name) == dict(tvalidation.CARD_RECIPE, **over)
    assert set(over) <= {"num_chains", "num_warmup", "num_samples", "ncp", "extra_opts"}
    assert tvalidation.card_recipe("conjugate_normal") == tvalidation.CARD_RECIPE
    order = tvalidation.card_order(NAMES)
    assert sorted(order) == sorted(NAMES)
    assert order[:len(tvalidation.CARD_COST_S)] == sorted(
        tvalidation.CARD_COST_S, key=lambda g: -tvalidation.CARD_COST_S[g])


@pytest.mark.gpu
def test_golds_compile_on_the_card():
    """Each gold compiled on the card equals its CPU compile at 8 points
    (the gold phase of chip_smoke.py runs the same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in NAMES:
        ok, e_lp, e_g = tvalidation.compile_check(_golds(name)[1])
        assert ok, (name, e_lp, e_g)
