"""The port's Stan frontend (``exmc_tpu_torch/stan``) against the JAX
package's on the programs of ``tests/test_stan.py`` and
``tests/test_stan_extended.py``: the same tokens and AST; the same
``StanSyntaxError`` text and line on the bad programs; the same node ids,
PointMap layout and flat size; the compiled log-density and gradient at
4 seeded points of a 4-chain batch (so that a factor summed over the
chain axis would show); the same ``generated_quantities`` on one trace
and seed; and the DSL's ``Model`` building the IR ``Builder`` builds.

Tolerance: float32 logp and gradient within 2e-5 of max(1, |value|);
generated quantities exact (the same float64 numpy code)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu import stan as jstan
from exmc_tpu.stan.lexer import tokenize as jtokenize
from exmc_tpu.stan.parser import parse as jparse
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch import stan as tstan
from exmc_tpu_torch.dists.base import Distribution as TDist
from exmc_tpu_torch.stan.lexer import StanSyntaxError
from exmc_tpu_torch.stan.lexer import tokenize as ttokenize
from exmc_tpu_torch.stan.parser import parse as tparse
from exmc_tpu_torch.transforms import Transform as TTransform

ES_DATA = {
    "J": 8,
    "y": np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]),
    "sigma": np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]),
}
_RNG = np.random.default_rng(0)
_X80 = _RNG.normal(size=(80, 4)).astype(np.float32)
_Y80 = (_RNG.random(80) < 1.0 / (1.0 + np.exp(-(_X80 @ np.array([1.0, -0.5, 0.25, 0.0]))))
        ).astype(np.float32)
_YS_BIN = _RNG.binomial(20, 0.35, size=30).astype(float)
_YS_NB = _RNG.poisson(_RNG.gamma(3.0, 4.0 / 3.0, size=50)).astype(float)
_X120 = _RNG.normal(size=120)
_Y120 = (_RNG.uniform(size=120) < 1 / (1 + np.exp(-1.5 * _X120))).astype(int)
_T6 = np.arange(1.0, 7.0, dtype=np.float32)

# (name, code, data): every program the JAX package's Stan tests compile
PROGRAMS = [
    ("basic", """
data { real y; }
parameters { real mu; }
model {
  mu ~ normal(0, 10);
  y ~ normal(mu, 1);
}
""", {"y": 5.0}),
    ("lower_zero", """
    parameters { real<lower=0> sigma; }
    model { sigma ~ half_normal(1); }
    """, None),
    ("unit_interval", """
    parameters { real<lower=0, upper=1> p; }
    model { p ~ beta(2, 2); }
    """, None),
    ("general_interval", """
    parameters { real<lower=-2, upper=3> x; }
    model { x ~ normal(0, 1); }
    """, None),
    ("vector_param", """
    data { int N; }
    parameters { vector[N] theta; }
    model { theta ~ normal(0, 1); }
    """, {"N": 3}),
    ("arithmetic_args", """
    parameters { real x; real<lower=0> tau; }
    model {
      tau ~ half_normal(2);
      x ~ normal(1 + 2, sqrt(tau) * 2);
    }
    """, None),
    ("negative_bounds", """
    parameters { real<lower=-2, upper=3> x; }
    model { x ~ normal(-1, 2); }
    """, None),
    ("arithmetic_e2e", """
    data { real y; }
    parameters { real mu; }
    model {
      mu ~ normal(0, 5 * 2);
      y ~ normal(mu / 2, 1);
    }
    """, {"y": 2.0}),
    ("uniform_unit", """
    parameters { real p; }
    model { p ~ uniform(0, 1); }
    """, None),
    ("uniform_general", """
    parameters { real theta; }
    model { theta ~ uniform(2, 5); }
    """, None),
    ("target_for_transformed", """
    data { int N; vector[N] y; }
    transformed data { real ybar = mean(y); }
    parameters { real mu; }
    transformed parameters { real shifted = mu + 1; }
    model {
      mu ~ normal(0, 1);
      target += normal_lpdf(y | mu, 1);
      for (i in 1:N) y[i] ~ normal(mu, 2);
    }
    """, {"N": 4, "y": np.array([0.5, 1.5, 2.5, 3.5], np.float32)}),
    ("target_lpdf_vector", """
    data { vector[3] y; }
    parameters { real mu; }
    model { mu ~ normal(0, 10); target += normal_lpdf(y | mu, 1); }
    """, {"y": np.array([1.0, 2.0, 3.0], np.float32)}),
    ("target_expression", """
    parameters { real mu; }
    model { mu ~ normal(0, 1); target += 2 * mu; }
    """, None),
    ("eight_schools_ncp", """
data { int J; vector[J] y; vector[J] sigma; }
parameters { real mu; real<lower=0> tau; vector[J] theta_raw; }
transformed parameters { vector[J] theta = mu + tau * theta_raw; }
model {
  mu ~ normal(0, 5);
  tau ~ half_cauchy(5);
  theta_raw ~ normal(0, 1);
  y ~ normal(theta, sigma);
}
""", ES_DATA),
    ("for_loop", """
    data { int N; vector[N] y; }
    parameters { real mu; }
    model {
      mu ~ normal(0, 5);
      for (i in 1:N) y[i] ~ normal(mu, 1);
    }
    """, {"N": 4, "y": np.array([0.5, 1.5, 2.5, 3.5], np.float32)}),
    ("for_loop_indexed_args", """
    data { vector[2] y; vector[2] s; }
    parameters { real mu; }
    model {
      mu ~ normal(0, 10);
      for (j in 1:2) y[j] ~ normal(mu, s[j]);
    }
    """, {"y": np.array([1.0, 2.0], np.float32), "s": np.array([0.5, 2.0], np.float32)}),
    ("matrix_logistic", """
    data { int N; int K; matrix[N, K] X; vector[N] y; }
    parameters { vector[K] beta; }
    model {
      beta ~ normal(0, 2.5);
      y ~ bernoulli(sigmoid(X * beta));
    }
    """, {"N": 80, "K": 4, "X": _X80, "y": _Y80}),
    ("transformed_data", """
    data { vector[3] y; }
    transformed data { real ybar = mean(y); real c = 2 * ybar; }
    parameters { real mu; }
    model { mu ~ normal(c, 1); y ~ normal(mu, 1); }
    """, {"y": np.array([1.0, 2.0, 3.0])}),
    ("matrix_parameter", """
    data { int N; int K; }
    parameters { matrix[N, K] B; }
    model { B ~ normal(0, 1); }
    """, {"N": 3, "K": 2}),
    ("data_lower_bound", """
    data { real y0; vector[4] y; }
    parameters { real<lower=y0> mu; }
    model { mu ~ normal(0, 10); y ~ normal(mu, 1); }
    """, {"y0": 5.0, "y": np.array([6.0, 7.0, 6.5, 7.5])}),
    ("upper_bound", """
    data { vector[4] y; }
    parameters { real<upper=2> mu; }
    model { mu ~ normal(0, 10); y ~ normal(mu, 1); }
    """, {"y": np.zeros(4)}),
    ("functions_block", """
    functions {
      real decline(real qi, real di, real t) { return qi / (1 + di * t); }
      real sq(real x) { return x * x; }
    }
    data { vector[6] t; vector[6] y; }
    parameters { real<lower=0> qi; real<lower=0> di; real<lower=0> s; }
    model {
      qi ~ lognormal(1, 1);
      di ~ lognormal(-2, 1);
      s ~ half_normal(1);
      y ~ normal(decline(qi, di, t), sq(s));
    }
    """, {"t": _T6, "y": (5.0 / (1.0 + 0.2 * _T6)).astype(np.float32)}),
    ("functions_nested_target", """
    functions {
      real half(real x) { return x / 2; }
      real quarter(real x) { return half(half(x)); }
    }
    parameters { real mu; }
    model { mu ~ normal(0, 1); target += quarter(mu); }
    """, {}),
    ("function_locals", """
    functions {
      real steps(real x) {
        real y = x * 2;
        real z = y + 1;
        return z * y;
      }
    }
    parameters { real mu; }
    model { mu ~ normal(0, 1); target += steps(mu); }
    """, {}),
    ("function_local_vector", """
    functions {
      real softabs_mean(vector x) {
        vector[6] a = x * x;
        real m = sum(a) / 6;
        return m;
      }
    }
    data { vector[6] y; }
    parameters { real mu; }
    model { mu ~ normal(0, 1); y ~ normal(softabs_mean(y) * 0 + mu, 1); }
    """, {"y": np.array([1.0, 2.0, 1.5, 0.5, 1.2, 1.8], np.float32)}),
    ("nullary_function", """
    functions { real c() { return 2.5; } }
    parameters { real mu; }
    model { mu ~ normal(c(), 1); }
    """, {}),
    ("eight_schools_affine", """
data { int J; vector[J] y; vector[J] sigma; }
parameters {
  real mu;
  real<lower=0> tau;
  vector<offset=mu, multiplier=tau>[J] theta;
}
model {
  mu ~ normal(0, 5);
  tau ~ half_cauchy(5);
  theta ~ normal(mu, tau);
  y ~ normal(theta, sigma);
}
""", ES_DATA),
    ("affine_constant", """
    parameters { real<offset=10, multiplier=2> x; }
    model { x ~ normal(10, 2); }
    """, {}),
    ("binomial", """
    data { int N; vector[N] y; vector[N] n; }
    parameters { real<lower=0, upper=1> p; }
    model {
      p ~ beta(2, 2);
      y ~ binomial(n, p);
    }
    """, {"N": 30, "y": _YS_BIN, "n": np.full(30, 20.0)}),
    ("neg_binomial_2", """
    data { int N; vector[N] y; }
    parameters { real<lower=0> mu; real<lower=0> phi; }
    model {
      mu ~ gamma(2, 0.5);
      phi ~ gamma(2, 0.5);
      y ~ neg_binomial_2(mu, phi);
    }
    """, {"N": 50, "y": _YS_NB}),
    ("generated_quantities", """
    data { int N; vector[N] y; }
    parameters { real mu; real<lower=0> sigma; }
    model { mu ~ normal(0, 10); sigma ~ half_normal(2); y ~ normal(mu, sigma); }
    generated quantities {
      real mu2 = mu * 2;
      vector[4] y_rep = normal_rng(mu, sigma);
      real y_rep_mean = mean(y_rep);
      real first_y = y[1];
      real chained = mu2 + y_rep_mean;
    }
    """, {"N": 6, "y": np.array([2.1, 1.8, 2.5, 2.0, 1.9, 2.3], np.float32)}),
    ("array_int_bernoulli", """
    data { int N; array[N] int y; array[N] real x; }
    parameters { real beta; }
    model {
      beta ~ normal(0, 2);
      y ~ bernoulli(sigmoid(beta * x));
    }
    """, {"N": 120, "y": _Y120, "x": _X120}),
    ("array_real_lower", """
    data { int N; array[N] real y; }
    parameters { array[N] real<lower=0> lam; }
    model {
      lam ~ exponential(1);
      y ~ normal(lam, 1);
    }
    """, {"N": 8, "y": np.abs(np.random.default_rng(1).normal(1.0, 0.5, 8))}),
    ("function_vector_local_data", """
    functions {
      real second_of_double(vector x) {
        vector[3] a = x + x;
        return a[2];
      }
    }
    data { vector[3] v; }
    parameters { real mu; }
    model { mu ~ normal(second_of_double(v), 1); }
    """, {"v": np.array([1.0, 2.0, 3.0], np.float32)}),
]
PROGRAM_IDS = [p[0] for p in PROGRAMS]

_GQ_BASE = """
    data { real y; }
    parameters { real mu; }
    model { mu ~ normal(0, 10); y ~ normal(mu, 1); }
    generated quantities { %s }
    """

# (name, code, data): programs both frontends reject at compile time
BAD_PROGRAMS = [
    ("unknown_dist", "parameters { real x; }\nmodel { x ~ nope(1); }", None),
    ("syntax_line_1", "parameters { real x }\nmodel { x ~ normal(0,1); }", None),
    ("uniform_nonconstant_bounds", """
    parameters { real a; real theta; }
    model {
      a ~ normal(0, 1);
      theta ~ uniform(a, 5);
    }
    """, None),
    ("for_partial_range", """
    data { vector[4] y; }
    parameters { real mu; }
    model { mu ~ normal(0, 1); for (i in 1:3) y[i] ~ normal(mu, 1); }
    """, {"y": np.zeros(4)}),
    ("loop_var_bare", """
    data { vector[2] y; }
    parameters { real mu; }
    model { mu ~ normal(0,1); for (i in 1:2) y[i] ~ normal(mu, i); }
    """, {"y": np.zeros(2)}),
    ("nonscalar_bound", """
    data { vector[4] y; }
    parameters { real<lower=y> mu; }
    model { mu ~ normal(0, 10); y ~ normal(mu, 1); }
    """, {"y": np.zeros(4)}),
    ("unknown_bound_name", """
    data { real y; }
    parameters { real<lower=zmin> mu; }
    model { mu ~ normal(0, 1); y ~ normal(mu, 1); }
    """, {"y": 0.0}),
    ("recursive_function", """
    functions { real f(real x) { return f(x) + 1; } }
    parameters { real mu; }
    model { mu ~ normal(f(1), 1); }
    """, {}),
    ("function_arity", """
    functions { real f(real a, real b) { return a + b; } }
    parameters { real mu; }
    model { mu ~ normal(f(1), 1); }
    """, {}),
    ("function_statement", """
        functions { real f(real x) { real y = x; y = y + 1; return y; } }
        parameters { real mu; }
        model { mu ~ normal(f(mu), 1); }
        """, {}),
    ("function_duplicate_local", """
        functions { real f(real x) { real x = 2; return x; } }
        parameters { real mu; }
        model { mu ~ normal(f(mu), 1); }
        """, {}),
    ("function_free_name", """
        functions { real f(real x) { return x * sigma; } }
        parameters { real mu; real<lower=0> sigma; }
        model { sigma ~ half_normal(1); mu ~ normal(f(2), 1); }
        """, {}),
    ("function_shadows_builtin", """
        functions { real log(real x) { return x; } }
        parameters { real mu; }
        model { mu ~ normal(0, 1); }
        """, {}),
    ("function_duplicate_parameter", """
        functions { real f(real x, real x) { return x; } }
        parameters { real mu; }
        model { mu ~ normal(f(1, 2), 1); }
        """, {}),
    ("affine_with_bounds", """
    parameters { real<lower=0, multiplier=2> x; }
    model { x ~ normal(0, 2); }
    """, {}),
    ("affine_unknown_ref", """
    parameters { real<offset=nope> x; }
    model { x ~ normal(0, 1); }
    """, {}),
    ("int_parameter", "parameters { int k; }\nmodel { }", None),
    ("int_array_parameter", "parameters { array[3] int k; }\nmodel { }", None),
    ("array_2d", "data { array[N, 2] int y; } parameters { real m; } "
                 "model { m ~ normal(0, 1); }", None),
    ("array_vector_element", "data { array[N] vector[2] y; } parameters { real m; }"
                             " model { m ~ normal(0, 1); }", None),
]


def _copy(data):
    return None if data is None else {k: np.array(v) if isinstance(v, np.ndarray) else v
                                      for k, v in data.items()}


def _error(compile_fn, code, data):
    try:
        compile_fn(code, _copy(data))
    except Exception as e:  # noqa: BLE001 - the class is checked by the caller
        return e
    raise AssertionError("the program compiled")


@pytest.mark.parametrize("name,code,data", PROGRAMS, ids=PROGRAM_IDS)
def test_tokens_and_ast_equal_jax(name, code, data):
    assert ttokenize(code) == jtokenize(code)
    assert tparse(code) == jparse(code)


@pytest.mark.parametrize("name,code,data", BAD_PROGRAMS, ids=[b[0] for b in BAD_PROGRAMS])
def test_bad_program_same_error(name, code, data):
    je = _error(jstan.compile, code, data)
    te = _error(tstan.compile, code, data)
    assert isinstance(te, StanSyntaxError) and type(je).__name__ == "StanSyntaxError"
    assert str(te) == str(je)
    assert te.line == je.line


def _op_sig(x):
    """A package-neutral form of an IR op component: dists and transforms
    by name, arrays by value, callables as such."""
    if isinstance(x, (TDist, exmc_tpu.dists.base.Distribution)):
        return ("dist", x.name)
    if isinstance(x, (TTransform, exmc_tpu.transforms.Transform)):
        return ("tf", x.name)
    if isinstance(x, (np.ndarray, jnp.ndarray, torch.Tensor)):
        return ("array", np.asarray(x).shape, np.asarray(x, np.float64).round(6).tolist())
    if isinstance(x, (list, tuple)):
        return tuple(_op_sig(e) for e in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _op_sig(v)) for k, v in x.items()))
    if callable(x):
        return "callable"
    if isinstance(x, (float, np.floating, int, np.integer)) and not isinstance(x, bool):
        return round(float(x), 6)
    return x


def _ir_sig(ir):
    return {nid: (_op_sig(n.op), tuple(n.deps), n.shape and tuple(n.shape))
            for nid, n in ir.nodes.items()}


@pytest.mark.parametrize("ncp", [False, True], ids=["centered", "ncp"])
@pytest.mark.parametrize("name,code,data", PROGRAMS, ids=PROGRAM_IDS)
def test_compiled_program_matches_jax(name, code, data, ncp):
    jir = jstan.compile(code, _copy(data))
    tir = tstan.compile(code, _copy(data))
    assert _ir_sig(tir) == _ir_sig(jir)
    jm = jcompiler.compile_logp(jir, ncp=ncp)
    tm = tcompiler.compile_logp(tir, ncp=ncp, device="cpu")
    assert sorted(tm.ir.nodes) == sorted(jm.ir.nodes)
    assert sorted(tm.ncp_info) == sorted(jm.ncp_info)
    assert tm.size == jm.size
    assert [(e.id, e.offset, e.length, tuple(e.shape)) for e in tm.pm.entries] == [
        (e.id, e.offset, e.length, tuple(e.shape)) for e in jm.pm.entries]
    x = np.random.default_rng(5).uniform(-1.5, 1.5, size=(4, tm.size)).astype(np.float32)
    jl, jg = jax.vmap(jm.value_and_grad)(jnp.asarray(x))
    tl, tg = tm.value_and_grad(torch.as_tensor(x))
    jl, jg = np.asarray(jl), np.asarray(jg)
    assert np.all(np.isfinite(jl))
    err_lp = np.abs(tl.numpy() - jl) / np.maximum(1.0, np.abs(jl))
    err_g = np.abs(tg.numpy() - jg) / np.maximum(1.0, np.abs(jg).max(-1, keepdims=True))
    assert err_lp.max() <= 2e-5 and err_g.max() <= 2e-5, (err_lp.max(), err_g.max())
    # one chain alone gets the density it gets in the batch
    l0, _ = tm.value_and_grad(torch.as_tensor(x[1:2]))
    assert abs(float(l0[0]) - float(tl[1])) <= 2e-5 * max(1.0, abs(float(tl[1])))


def _gq_trace(ir, chains=2, draws=5, seed=3):
    """A trace of every free parameter: draws in (0.5, 1.5) fit every
    constraint of the GQ programs."""
    m = tcompiler.compile_logp(ir, device="cpu")
    rng = np.random.default_rng(seed)
    return {e.id: rng.uniform(0.5, 1.5, size=(chains, draws) + tuple(e.shape))
            for e in m.pm.entries}


@pytest.mark.parametrize("case", ["rows", "size_equals_draws"])
def test_generated_quantities_equal_jax(case):
    if case == "rows":
        _, code, data = PROGRAMS[PROGRAM_IDS.index("generated_quantities")]
        draws = 7
    else:
        code, data = _GQ_BASE % "vector[5] y_rep = normal_rng(mu, 1);", {"y": 1.0}
        draws = 5
    jir, tir = jstan.compile(code, _copy(data)), tstan.compile(code, _copy(data))
    trace = _gq_trace(tir, draws=draws)
    got = tstan.generated_quantities(tir, trace, seed=11)
    want = jstan.generated_quantities(jir, trace, seed=11)
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("row,match", [("real a = frobnicate(mu);", "unknown function"),
                                       ("real mu = mu * 2;", "shadows")])
def test_generated_quantities_errors_equal_jax(row, match):
    code = _GQ_BASE % row
    trace = {"mu": np.zeros((1, 3))}
    errs = []
    for pkg in (jstan, tstan):
        with pytest.raises(Exception, match=match) as info:
            pkg.generated_quantities(pkg.compile(code, {"y": 1.0}), trace, seed=0)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


def test_stan_sample_with_generated_quantities():
    """``stan.sample`` on the CPU: the trace carries the GQ rows."""
    _, code, data = PROGRAMS[PROGRAM_IDS.index("generated_quantities")]
    trace, stats = tstan.sample(code, _copy(data), num_chains=2, num_warmup=60,
                                num_samples=40, seed=0, device="cpu")
    assert trace["mu2"].shape == (2, 40) and trace["y_rep"].shape == (2, 40, 4)
    np.testing.assert_allclose(trace["mu2"], 2 * trace["mu"], rtol=1e-6)
    np.testing.assert_allclose(trace["y_rep_mean"], trace["y_rep"].mean(-1), rtol=1e-6)
    assert np.isfinite(trace["mu"]).all() and stats["step_size"].shape == (2,)


def test_compile_or_error():
    status, msg = tstan.compile_or_error(BAD_PROGRAMS[0][1])
    assert (status, msg) == jstan.compile_or_error(BAD_PROGRAMS[0][1])
    status, ir = tstan.compile_or_error(PROGRAMS[0][1], {"y": 5.0})
    assert status == "ok" and "mu" in ir.nodes


def _dsl_model(pkg, y):
    with pkg.Model() as m:
        m.rv("mu", pkg.dists.Normal, {"mu": 0.0, "sigma": 5.0})
        m.rv("sigma", pkg.dists.HalfNormal, {"sigma": 1.0})
        m.rv("y", pkg.dists.Normal, {"mu": "mu", "sigma": "sigma"}, shape=(5,))
        m.obs("y_obs", "y", y)
        m.matmul("xm", np.eye(5, dtype=np.float32), "y")
        m.affine("xa", 2.0, 1.0, "mu")
        m.det("xd", "exp", ["mu"])
        m.data(y)
    return m.ir


def _builder_model(pkg, y):
    B = pkg.Builder
    ir = B.new_ir()
    ir = B.rv(ir, "mu", pkg.dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "sigma", pkg.dists.HalfNormal, {"sigma": 1.0})
    ir = B.rv(ir, "y", pkg.dists.Normal, {"mu": "mu", "sigma": "sigma"}, shape=(5,))
    ir = B.obs(ir, "y_obs", "y", y)
    ir = B.det(ir, "xm", "matmul", [np.eye(5, dtype=np.float32), "y"])
    ir = B.det(ir, "xa", "affine", [2.0, 1.0, "mu"])
    ir = B.det(ir, "xd", "exp", ["mu"])
    return B.data(ir, y)


def test_dsl_model_builds_the_builder_ir():
    y = np.random.default_rng(2).normal(size=5).astype(np.float32)
    tir = _dsl_model(exmc_tpu_torch, y)
    assert _ir_sig(tir) == _ir_sig(_builder_model(exmc_tpu_torch, y))
    assert _ir_sig(tir) == _ir_sig(_dsl_model(exmc_tpu, y))
    np.testing.assert_array_equal(tir.data, y)
