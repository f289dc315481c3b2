"""The port's cross-rank diagnostics (``exmc_tpu_torch.parallel.diagnostics``)
against the JAX package's on the conftest's 8-device mesh and against the
host estimators, on the same numpy draws.

One group of four gloo ranks on the CPU computes every case: each rank
passes its block of 4 of the 16 (or 8 of the 32) chains. Tolerances are
f32 ones: R-hat and nested R-hat within 1e-5 relative of JAX's and the
host's, ESS within 1e-4 (the JAX package's own sharded-vs-host bound);
with a common offset of 1e3 the host estimators themselves carry f32
noise, so there the JAX test's bounds hold (1e-3 for the R-hats, 5 % for
ESS). JAX is imported only by the tests, never by the ranks.
"""

import numpy as np
import pytest
import torch

from exmc_tpu_torch import diagnostics as tdiag
from exmc_tpu_torch.benchmarks.parallel import start_ranks
from exmc_tpu_torch.parallel import (
    make_mesh,
    sharded_ess,
    sharded_nested_rhat,
    sharded_rhat,
)

WORLD = 4


def _draws():
    """name -> (chains, n) float32 draws, the JAX tests' seeds and shapes."""
    rng = [np.random.default_rng(s) for s in range(7)]
    bad = rng[1].normal(size=(16, 300))
    bad[3] += 5.0
    unmixed = rng[3].normal(scale=0.1, size=(16, 512)) + np.arange(16)[:, None] * 5.0
    stuck = rng[5].normal(size=(32, 50))
    stuck[0:4] += 10.0
    out = {"rhat": rng[0].normal(size=(16, 400)), "bad_chain": bad,
           "ess": rng[2].normal(size=(16, 512)), "unmixed": unmixed,
           "nested": rng[4].normal(size=(32, 50)), "stuck": stuck,
           "offset": rng[6].normal(size=(32, 200)) * 0.01 + 1000.0}
    return {k: v.astype(np.float32) for k, v in out.items()}


# (case, statistic, num_superchains)
CASES = [("rhat", "rhat", None), ("bad_chain", "rhat", None), ("ess", "ess", None),
         ("unmixed", "ess", None), ("nested", "nested_rhat", 8), ("stuck", "nested_rhat", 8),
         ("offset", "rhat", None), ("offset", "nested_rhat", 8), ("offset", "ess", None)]


def _rank_main(rank):
    """Every case on this rank's block of chains, and the refusals."""
    mesh = make_mesh(dp=WORLD, device="cpu")
    draws = _draws()
    out = {}
    for case, stat, k in CASES:
        x = draws[case]
        loc = x[mesh.axis("dp").block(x.shape[0])]
        if stat == "rhat":
            out[case, stat] = float(sharded_rhat(loc, mesh))
        elif stat == "ess":
            out[case, stat] = float(sharded_ess(loc, mesh))
        else:
            out[case, stat] = float(sharded_nested_rhat(loc, mesh, k))
    errors = {}
    # 16 chains over 4 ranks hold 4 each; K = 2 makes superchains of 8
    try:
        sharded_nested_rhat(np.zeros((4, 10), np.float32), mesh, num_superchains=2)
    except ValueError as e:
        errors["split"] = str(e)
    # rank 0 holds 2 chains, the others 6: 20 chains, unevenly split
    try:
        sharded_nested_rhat(np.zeros((2 if rank == 0 else 6, 10), np.float32), mesh, 2)
    except ValueError as e:
        errors["uneven"] = str(e)
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = start_ranks(_rank_main, WORLD, workdir=str(tmp_path_factory.mktemp("pg")),
                      timeout_s=120)
    try:
        jax_ref = _jax_reference()
    except BaseException:
        run.kill()
        raise
    return run.wait(), jax_ref


def _jax_reference():
    import jax.numpy as jnp

    from exmc_tpu.parallel import diagnostics as jdiag
    from exmc_tpu.parallel.sharding import make_mesh as jax_mesh

    mesh = jax_mesh(8, dp=8, sp=1)
    draws = _draws()
    out = {}
    with mesh:
        for case, stat, k in CASES:
            x = jnp.asarray(draws[case])
            if stat == "nested_rhat":
                out[case, stat] = float(jdiag.sharded_nested_rhat(x, mesh, k))
            else:
                out[case, stat] = float(getattr(jdiag, f"sharded_{stat}")(x, mesh))
    return out


def _host(case, stat, k):
    x = _draws()[case]
    if stat == "nested_rhat":
        return float(tdiag.nested_rhat(x, k))
    return float(getattr(tdiag, stat)(x))


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("case,stat,k", [c for c in CASES if c[0] != "offset"])
def test_sharded_statistic_matches_jax_and_host(ranks, case, stat, k):
    """Every rank gets the same value, within f32 rounding of JAX's
    sharded statistic and of the host estimator on all chains."""
    results, jax_ref = ranks
    got = [r[case, stat] for r in results]
    assert len(set(got)) == 1, got
    tol = 1e-4 if stat == "ess" else 1e-5
    assert _rel(got[0], jax_ref[case, stat]) < tol, (got[0], jax_ref[case, stat])
    assert _rel(got[0], _host(case, stat, k)) < tol


def test_sharded_diagnostics_flag_what_the_jax_tests_flag(ranks):
    results, _ = ranks
    r = results[0]
    assert r["bad_chain", "rhat"] > 1.5
    assert r["unmixed", "ess"] < 60
    assert r["stuck", "nested_rhat"] > 1.5


@pytest.mark.parametrize("stat", ["rhat", "nested_rhat", "ess"])
def test_sharded_diagnostics_survive_large_offset(ranks, stat):
    """A common offset of 1e3: the centred two-pass between-variance keeps
    the sharded statistics on the host's and JAX's (a one-pass
    E[x^2] - E[x]^2 would cancel in f32)."""
    results, jax_ref = ranks
    got = results[0]["offset", stat]
    tol = 0.05 if stat == "ess" else 1e-3
    assert np.isfinite(got)
    assert _rel(got, _host("offset", stat, 8)) < tol
    assert _rel(got, jax_ref["offset", stat]) < tol


def test_sharded_nested_rhat_rejects_split_superchains(ranks):
    results, _ = ranks
    for r in results:
        assert "whole number" in r["errors"]["split"]


def test_sharded_nested_rhat_rejects_uneven_shards(ranks):
    """The port checks c % n_dev == 0 and equal shards, which the JAX
    package does not: every rank raises the same error."""
    results, _ = ranks
    msgs = {r["errors"]["uneven"] for r in results}
    assert len(msgs) == 1 and "not split evenly" in msgs.pop()


def test_one_rank_without_a_group_is_the_host_estimator():
    """Without a process group the collectives are the identity and the
    sharded statistics are the host's, in the input's dtype and device."""
    mesh = make_mesh(device="cpu")
    x = _draws()["rhat"]
    assert _rel(float(sharded_rhat(x, mesh)), float(tdiag.rhat(x))) < 1e-6
    assert _rel(float(sharded_ess(x, mesh)), float(tdiag.ess(x))) < 1e-6
    nx = _draws()["nested"]
    assert _rel(float(sharded_nested_rhat(torch.as_tensor(nx), mesh, 8)),
                float(tdiag.nested_rhat(nx, 8))) < 1e-6
