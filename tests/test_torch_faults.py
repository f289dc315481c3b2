"""The port's four faults of ROADMAP §3, each held by a test that fails
without its repair:

* det callables apply one point at a time (``torch.func.vmap`` over the
  chain axis): a reducing lambda and an indexing lambda give each row
  the JAX package's per-point logp and gradient (1e-5 relative); a
  callable vmap cannot run, or an argument whose rows are neither one
  nor the batch's, fails naming the node; the Stan frontend's
  ``_batched`` factor callables keep the batch;
* the top-level exports: the port's ``__all__`` is the JAX package's and
  ``particle``;
* ``sample_stream(mechanism=...)``: "chunked" and "io_callback" give the
  callback the same draws and the run the same result, at different
  times; another value is refused, as an unknown option still is;
* the benchmark harness: ``run_model(seeds=, ncp=, chunked=, **opts)``,
  ``run_suite`` and ``validate(full=)``;
* the public diagnostics return numpy arrays, as ``np.asarray`` of the
  JAX package's results: numpy's reductions and ``float`` work on every
  statistic, and example 43's ``np.min(ebfmi(stats["energy"]))`` line
  runs on the port's own sampler output.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu_torch.benchmarks import post, suite, validation
from exmc_tpu_torch.compiler import _per_point
from exmc_tpu_torch.ir import _batched
from exmc_tpu_torch.nuts import sampler as tsampler

RTOL = 1e-5
IDX = np.array([0, 2, 2, 1])


def _probe(pkg, fn, shape=()):
    """theta (3,) feeding a Normal mean through the det callable ``fn``
    whose value has ``shape``."""
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "th", D.Normal, {"mu": 0.0, "sigma": 1.0}, shape=(3,))
    ir = B.det(ir, "s", fn, ["th"])
    ir = B.rv(ir, "y", D.Normal, {"mu": "s", "sigma": 1.0})
    return B.obs(ir, "y_obs", "y", np.full(shape, 0.5, np.float32))


CALLABLES = {  # name: (JAX callable, port callable, value shape)
    "sum": (lambda th: jnp.sum(th), lambda th: th.sum(), ()),
    "index": (lambda th: th[IDX], lambda th: th[IDX], (4,)),
    "scaled": (lambda th: jnp.exp(th / 2) * jnp.arange(3.0),
               lambda th: torch.exp(th / 2) * torch.arange(3.0), (3,)),
}


@pytest.mark.parametrize("name", sorted(CALLABLES))
def test_det_callable_is_applied_per_point(name):
    jfn, tfn, shape = CALLABLES[name]
    jm = exmc_tpu.compile_logp(_probe(exmc_tpu, jfn, shape))
    tm = exmc_tpu_torch.compile_logp(_probe(exmc_tpu_torch, tfn, shape), device="cpu")
    x = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    lp, g = tm.value_and_grad(torch.as_tensor(x))
    for i in range(4):
        want, want_g = jax.value_and_grad(jm.logp)(jnp.asarray(x[i]))
        np.testing.assert_allclose(float(lp[i]), float(want), rtol=RTOL)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(want_g), rtol=RTOL, atol=1e-6)


def test_det_callable_that_cannot_vmap_names_the_node():
    B, D = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    ir = B.rv(B.new_ir(), "th", D.Normal, {"mu": 0.0, "sigma": 1.0}, shape=(3,))
    ir = B.det(ir, "masked_sum", lambda th: th[th > 0].sum(), ["th"])
    ir = B.rv(ir, "y", D.Normal, {"mu": "masked_sum", "sigma": 1.0})
    ir = B.obs(ir, "y_obs", "y", 0.0)
    with pytest.raises(ValueError, match="'masked_sum'.*vmap"):
        exmc_tpu_torch.compile_logp(ir, device="cpu")


def test_det_callable_rows_must_match_the_batch():
    """Data of one row broadcasts to every chain; data of as many rows as
    chains goes row by row; any other row count is refused, not read as
    row 0 for every chain."""
    th = torch.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(
        _per_point("s", lambda t, y: (t * y).sum(), [th, torch.ones(1, 3)]).numpy(),
        th.sum(-1).numpy())
    rows = torch.arange(4.0)[:, None].expand(4, 3)
    np.testing.assert_array_equal(
        _per_point("s", lambda t, y: (t * y).sum(), [th, rows]).numpy(),
        (th * rows).sum(-1).numpy())
    with pytest.raises(ValueError, match="'s'.*3 rows.*4 chains"):
        _per_point("s", lambda t, y: (t * y).sum(), [th, torch.ones(3, 3)])


def test_batched_callable_sees_the_chain_axis():
    seen = []

    @_batched  # the Stan frontend's factor callables
    def row_sum(th):
        seen.append(tuple(th.shape))
        return th.sum(-1)

    tm = exmc_tpu_torch.compile_logp(_probe(exmc_tpu_torch, row_sum), device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 3)), dtype=torch.float32)
    per_point = exmc_tpu_torch.compile_logp(
        _probe(exmc_tpu_torch, lambda th: th.sum()), device="cpu").logp(x)
    seen.clear()
    np.testing.assert_allclose(tm.logp(x).numpy(), per_point.numpy(), rtol=RTOL)
    assert seen == [(5, 3)]


def test_det_callable_on_card_is_graphed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = post.check_det_callable("cuda")
    assert res["ok"] and res["graphed"], res


def test_all_is_the_jax_packages_less_the_model_families():
    # the model families are ported: nothing is left out, and the
    # particle subpackage is exported too
    assert set(exmc_tpu_torch.__all__) == set(exmc_tpu.__all__) | {"particle"}
    assert len(exmc_tpu_torch.__all__) == len(set(exmc_tpu_torch.__all__))
    for name in exmc_tpu_torch.__all__:
        assert getattr(exmc_tpu_torch, name) is not None
    assert exmc_tpu_torch.compile_for_sampling is exmc_tpu_torch.compile_logp
    assert exmc_tpu_torch.PointMap.__module__ == "exmc_tpu_torch.point_map"
    for mod in ("diagnostics", "transforms", "log_prob", "model_comparison",
                "predictive", "sbc", "gp", "hmm", "glm", "particle"):
        assert getattr(exmc_tpu_torch, mod).__name__ == f"exmc_tpu_torch.{mod}"


# ---------------------------------------------------------------------------
# sample_stream(mechanism=...)
# ---------------------------------------------------------------------------

def _counting_model():
    """The quickstart model whose value-and-grad counts its calls."""
    B, D = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    ys = np.array([2.1, 1.8, 2.5, 2.0, 1.9, 2.3, 2.2, 1.7, 2.4, 2.6], np.float32)
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "sigma", D.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "x", D.Normal, {"mu": "mu", "sigma": "sigma"})
    model = exmc_tpu_torch.compile_logp(B.obs(ir, "x_obs", "x", ys), device="cpu")
    calls = [0]
    vag = model.value_and_grad

    def counted(q, data=None):
        calls[0] += 1
        return vag(q, data)

    model.value_and_grad = counted
    return model, calls


def _stream(mechanism):
    model, calls = _counting_model()
    got = []

    def cb(i, point, stats):
        got.append((i, point["mu"].copy(), calls[0]))

    trace, _ = exmc_tpu_torch.sample_stream(
        model, cb, num_chains=3, seed=4, every=5, mechanism=mechanism,
        num_warmup=10, num_samples=30)
    return got, trace


def test_sample_stream_mechanisms_agree_and_differ_in_timing():
    chunked, t_chunked = _stream("chunked")
    io, t_io = _stream("io_callback")
    assert [g[0] for g in chunked] == [g[0] for g in io] == list(range(4, 30, 5))
    for a, b in zip(chunked, io):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], t_io["mu"][:, a[0]])
    np.testing.assert_array_equal(t_chunked["mu"], t_io["mu"])
    # "io_callback" is called from the loop as draw 4 is made; "chunked"
    # only once its chunk of 25 iterations (10 warmup + 15 draws) is done
    assert io[0][2] < chunked[0][2]
    assert chunked[0][2] == chunked[2][2]  # draws 4, 9, 14: one chunk


def test_sample_stream_refuses_other_mechanisms_and_options():
    model, _ = _counting_model()
    with pytest.raises(ValueError, match="mechanism"):
        exmc_tpu_torch.sample_stream(model, print, every=2, mechanism="threads",
                                     num_warmup=5, num_samples=5)
    with pytest.raises(TypeError, match="unknown sampler options"):
        exmc_tpu_torch.sample_stream(model, print, every=2, mechanism="chunked",
                                     num_warmup=5, num_samples=5, bogus=1)
    with pytest.raises(ValueError, match="every"):
        tsampler.sample_stream(model, print, every=0, mechanism="io_callback")


# ---------------------------------------------------------------------------
# the benchmark harness
# ---------------------------------------------------------------------------

def test_run_model_seeds_ncp_chunked_and_options():
    kw = dict(num_chains=4, num_warmup=20, num_samples=20, device="cpu", warm_up=(2, 2))
    one = suite.run_model("simple", **kw)
    two = suite.run_model("simple", seeds=2, **kw)
    assert one["n_seeds"] == 1 and len(one["per_seed"]) == 1
    assert two["n_seeds"] == 2 and len(two["per_seed"]) == 2
    # the first timed seed is the same run either way
    assert two["per_seed"][0]["min_ess"] == one["min_ess"]
    assert two["min_ess"] == pytest.approx(np.median([r["min_ess"] for r in two["per_seed"]]))
    chunked = suite.run_model("simple", chunked=7, **kw)
    assert chunked["posterior"] == one["posterior"]
    centered = suite.run_model("simple", ncp=False, max_tree_depth=3, **kw)
    assert centered["d"] == one["d"] and centered["mean_depth"] <= 3


def test_run_suite_and_validate_full():
    res = suite.run_suite(["simple", "funnel"], num_chains=2, num_warmup=10,
                          num_samples=10, device="cpu", warm_up=(2, 2))
    assert sorted(res) == ["funnel", "simple"]
    assert all(r["model"] == k for k, r in res.items())
    kw = dict(num_warmup=20, num_samples=20, num_chains=2, verbose=False, device="cpu")
    _, core = validation.validate(full=False, models=["conjugate_normal", "exponential_gamma"],
                                  **kw)
    assert [r["model"] for r in core] == ["conjugate_normal"]
    _, full = validation.validate(full=True, models=["conjugate_normal", "exponential_gamma"],
                                  **kw)
    assert sorted(r["model"] for r in full) == ["conjugate_normal", "exponential_gamma"]


# ---------------------------------------------------------------------------
# diagnostics return numpy
# ---------------------------------------------------------------------------

_STATS = {
    "ess": lambda d, x: d.ess(x),
    "ess_bulk": lambda d, x: d.ess_bulk(x),
    "ess_tail": lambda d, x: d.ess_tail(x),
    "rhat": lambda d, x: d.rhat(x),
    "rhat_bulk": lambda d, x: d.rhat_bulk(x),
    "nested_rhat": lambda d, x: d.nested_rhat(x, 2),
    "ebfmi": lambda d, x: d.ebfmi(x),
    "autocorrelation": lambda d, x: d.autocorrelation(x, max_lag=5),
    "quantile": lambda d, x: d.quantile(x, [0.1, 0.5, 0.9]),
}


@pytest.mark.parametrize("name", sorted(_STATS))
def test_public_diagnostics_reduce_with_numpy(name):
    x = np.random.default_rng(3).normal(size=(4, 200)).astype(np.float32)
    from exmc_tpu import diagnostics as jd
    from exmc_tpu_torch import diagnostics as td
    for inp in (x, torch.as_tensor(x)):
        got = _STATS[name](td, inp)
        ref = np.asarray(_STATS[name](jd, jnp.asarray(x)))
        assert isinstance(got, np.ndarray) and got.shape == ref.shape, name
        np.testing.assert_allclose(np.min(got), np.min(ref), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.max(got), np.max(ref), rtol=1e-4, atol=1e-5)
        if ref.ndim == 0:
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)
    rows = td.summary({"x": x})
    assert all(isinstance(v, float) for v in rows["x"].values())


def test_example_43_diagnostics_line():
    from exmc_tpu_torch.diagnostics import ebfmi, ess, rhat
    B, D = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    y = np.random.default_rng(0).standard_t(3, size=60) + 2.0
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = B.rv(ir, "sigma", D.HalfNormal, {"sigma": 5.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": "sigma"}, shape=(60,))
    ir = B.obs(ir, "y_obs", "y", y)
    tr, st = exmc_tpu_torch.sample(ir, num_chains=4, num_warmup=100,
                                   num_samples=100, seed=0, device="cpu")
    line = (f"robust R-hat(mu) {rhat(tr['mu']):.4f}, "
            f"ESS {ess(tr['mu']):.0f}, "
            f"E-BFMI {np.min(ebfmi(st['energy'])):.2f}, "
            f"div {int(st['divergences'].sum())}")
    assert "E-BFMI" in line
    assert 0.2 < np.min(ebfmi(st["energy"])) < 3.0
