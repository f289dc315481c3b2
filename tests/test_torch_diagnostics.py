"""The port's new diagnostics against the JAX package's on seeded arrays:
ess_bulk, ess_tail, rhat_bulk, ebfmi, autocorrelation, quantile and
summary, including tied draws (a tail indicator is mostly ties) and an
offset where a one-pass between-chain variance would cancel.

Inputs are float32 on both sides; tolerance 1e-4 relative (the FFT and
the ranks' probit differ in the last float32 bits)."""

import numpy as np
import pytest
import jax.numpy as jnp

from exmc_tpu import diagnostics as jd
from exmc_tpu_torch import diagnostics as td


def _chains(seed, c=4, n=400, rho=0.6, offset=0.0, ties=False):
    """AR(1) chains with per-chain shifts (c, n), float32."""
    rng = np.random.default_rng(seed)
    x = np.zeros((c, n))
    e = rng.normal(size=(c, n))
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + e[:, t]
    x += offset + 0.1 * rng.normal(size=(c, 1))
    if ties:
        x = np.round(x)
    return x.astype(np.float32)


CASES = [
    ("plain", dict(seed=0)),
    ("sticky", dict(seed=1, rho=0.95)),
    ("offset_1000", dict(seed=2, offset=1000.0)),
    ("ties", dict(seed=3, ties=True)),
    ("one_chain", dict(seed=4, c=1)),
]


@pytest.mark.parametrize("fn", ["ess_bulk", "ess_tail", "rhat_bulk"])
@pytest.mark.parametrize("case,kw", CASES, ids=[c[0] for c in CASES])
def test_rank_diagnostics_match_jax(fn, case, kw):
    x = _chains(**kw)
    if fn == "rhat_bulk" and x.shape[0] == 1:
        x = np.concatenate([x, _chains(seed=9, c=1)])
    ref = float(getattr(jd, fn)(jnp.asarray(x)))
    got = float(getattr(td, fn)(x))
    np.testing.assert_allclose(got, ref, rtol=1e-4)


@pytest.mark.parametrize("case,kw", CASES, ids=[c[0] for c in CASES])
def test_ebfmi_autocorrelation_quantile_match_jax(case, kw):
    x = _chains(**kw)
    np.testing.assert_allclose(td.ebfmi(x), np.asarray(jd.ebfmi(jnp.asarray(x))),
                               rtol=1e-4)
    np.testing.assert_allclose(td.autocorrelation(x, max_lag=50),
                               np.asarray(jd.autocorrelation(jnp.asarray(x), max_lag=50)),
                               rtol=1e-4, atol=2e-5)
    qs = [0.0, 0.05, 0.25, 0.5, 0.75, 0.95, 1.0]
    np.testing.assert_allclose(td.quantile(x, qs),
                               np.asarray(jd.quantile(jnp.asarray(x), jnp.asarray(qs))),
                               rtol=1e-6)
    np.testing.assert_allclose(td.quantile(x, qs), np.quantile(x, qs), rtol=1e-6)


def test_ebfmi_one_dimensional_input():
    e = _chains(seed=5, c=1)[0]
    np.testing.assert_allclose(td.ebfmi(e), np.asarray(jd.ebfmi(jnp.asarray(e))),
                               rtol=1e-4)


def test_summary_matches_jax():
    trace = {"mu": _chains(seed=6)[..., None][..., 0],
             "beta": np.stack([_chains(seed=7), _chains(seed=8, rho=0.9)], axis=-1)}
    ref = jd.summary(trace)
    got = td.summary(trace)
    assert sorted(got) == sorted(ref) == ["beta[0]", "beta[1]", "mu"]
    for key, row in ref.items():
        assert sorted(got[key]) == sorted(row)
        for stat, v in row.items():
            np.testing.assert_allclose(got[key][stat], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{key}.{stat}")
    only = td.summary(trace, var_names=["mu"])
    assert list(only) == ["mu"]
