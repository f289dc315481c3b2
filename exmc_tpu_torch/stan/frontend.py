"""Stan AST -> IR compiler: the port of ``exmc_tpu/stan/frontend.py``
(reference lib/exmc/stan/compiler.ex), building the same IR with the
port's ``Builder`` and dists.

The two log-density factors the frontend writes as callable det nodes
(``<dist>_lpdf`` calls and the affine Jacobian) receive aligned (C, ...)
tensors with the chain axis first, as every det callable does in the
port (``compiler.py``): they reduce the event axes only, so each chain
keeps its own log-density, and ``log(m)`` is broadcast to the value's
event shape before its sum. Generated quantities are host numpy, as in
the JAX package.

Semantics preserved:
* parameters -> free RVs; ``<lower=0>`` -> log transform,
  ``<lower=0,upper=1>`` -> logit (stan/compiler.ex:61-97); other
  two-sided bounds get an interval transform (extension);
* data variables appearing on the left of ``~`` become an RV + obs pair
  (stan/compiler.ex:61-97);
* ``simplex[K]`` parameters get the Dirichlet stick-breaking treatment
  when sampled from ``dirichlet``;
* errors carry line context (stan.ex:100-110).

Round-2 extensions (EXCEEDING the reference's stated limits,
stan.ex:31-36 "no target +=, no loops, no transformed blocks"):
* ``transformed data { real x = expr; }`` — evaluated eagerly on the
  host (numpy float64) and folded into the data environment;
* ``transformed parameters { vector[J] theta = expr; }`` — det nodes,
  usable anywhere a parameter reference is (the eight-schools NCP
  ``theta = mu + tau * theta_raw`` pattern);
* ``target += expr;`` — arbitrary log-density increments, including
  ``<dist>_lpdf(value | args)`` / ``_lpmf`` calls, lowered to an
  observed Custom factor node;
* ``for (i in 1:N) y[i] ~ dist(args[i]);`` — loops are VECTORIZED at
  compile time (the TPU-native lowering: a loop whose body indexes by
  the loop variable over the full range is exactly a whole-vector
  statement; no per-element graph nodes, no trace growth);
* ``matrix[N, K]`` data + Stan's ``*`` as matmul when the left operand
  is a matrix (det op "smul");
* ``matrix[N, K]`` parameters (elementwise priors over the flattened
  block, round-3);
* constraint bounds referencing scalar data, e.g.
  ``real<lower=min_y> y0;`` (round-3);
* ``<offset=o, multiplier=m>`` affine parameters (Stan manual §25.7),
  o/m constants, data scalars, or PARAMETERS — the manual non-centering
  idiom ``vector<offset=mu, multiplier=tau>[J] theta;`` lowers onto the
  NCP reconstruction machinery with the exact Jacobian adjustment
  (round-3; see ``emit_affine``); constraints parse in Stan's
  before-the-bracket position ``vector<lower=0>[N]`` as well as the
  legacy ``vector[N]<lower=0>``.
"""

import numpy as np

from dataclasses import replace as _replace

import torch

from exmc_tpu_torch import dists
from exmc_tpu_torch.compiler import _align_dist
from exmc_tpu_torch.ir import Builder, _batched
from exmc_tpu_torch.math import event_sum
from exmc_tpu_torch.stan.lexer import StanSyntaxError
from exmc_tpu_torch.stan.parser import parse
from exmc_tpu_torch.transforms import (
    IntervalTransform,
    LowerBoundTransform,
    UpperBoundTransform,
)

# Stan-name -> (dist, ordered param names) (reference stan/dist_map.ex:25-42)
DIST_MAP = {
    "normal": (dists.Normal, ["mu", "sigma"]),
    "gamma": (dists.Gamma, ["alpha", "beta"]),
    "exponential": (dists.Exponential, ["lambda"]),
    "beta": (dists.Beta, ["alpha", "beta"]),
    "half_normal": (dists.HalfNormal, ["sigma"]),
    "half_cauchy": (dists.HalfCauchy, ["scale"]),
    "cauchy": (dists.Cauchy, ["loc", "scale"]),
    "student_t": (dists.StudentT, ["df", "loc", "scale"]),
    "bernoulli": (dists.Bernoulli, ["p"]),
    "bernoulli_logit": (dists.Bernoulli, ["logits"]),
    "poisson": (dists.Poisson, ["mu"]),
    "binomial": (dists.Binomial, ["n", "p"]),
    "binomial_logit": (dists.Binomial, ["n", "logits"]),
    # Stan's neg_binomial_2(mu, phi) IS the mu/alpha parameterization
    "neg_binomial_2": (dists.NegativeBinomial, ["mu", "alpha"]),
    "categorical": (dists.Categorical, ["p"]),
    "multinomial": (dists.Multinomial, ["p"]),
    "lkj_corr_cholesky": (dists.LKJCholesky, ["eta"]),
    "lognormal": (dists.LogNormal, ["mu", "sigma"]),
    "truncated_normal": (dists.TruncatedNormal, ["mu", "sigma", "lower", "upper"]),
    "laplace": (dists.Laplace, ["mu", "b"]),
    "dirichlet": (dists.Dirichlet, ["alpha"]),
    "weibull": (dists.Weibull, ["k", "lambda"]),
    # Stan's uniform takes (lower, upper); constant (0,1) is the
    # reference's Uniform01, general constant bounds use the interval
    # transform (ADVICE r1)
    "uniform": (dists.Uniform, ["lower", "upper"]),
    "inv_gamma": (dists.InverseGamma, ["alpha", "beta"]),
    "gumbel": (dists.Gumbel, ["loc", "scale"]),
    "beta_binomial": (dists.BetaBinomial, ["n", "alpha", "beta"]),
    "ordered_logistic": (dists.OrderedLogistic, ["eta", "cutpoints"]),
}

_FNS = {"sqrt", "exp", "log", "abs", "softplus", "sigmoid", "sum", "mean"}


def _constraint_transform(decl):
    lower, upper = decl.get("lower"), decl.get("upper")
    if lower is None and upper is None:
        return None
    if lower == 0.0 and upper is None:
        return "log"
    if lower == 0.0 and upper == 1.0:
        return "logit"
    if lower is not None and upper is not None:
        return IntervalTransform(lower, upper)
    if lower is not None:
        return LowerBoundTransform(lower)  # x = lower + exp(z)
    return UpperBoundTransform(upper)      # x = upper - exp(z)


def _lookup_dist(name, line):
    try:
        return DIST_MAP[name]
    except KeyError:
        supported = ", ".join(sorted(DIST_MAP))
        raise StanSyntaxError(
            f"unknown distribution {name!r}. Supported: {supported}",
            line=line,
        ) from None


_NP_FNS = {
    "sqrt": np.sqrt, "exp": np.exp, "log": np.log, "abs": np.abs,
    "sum": np.sum, "mean": np.mean,
    "softplus": lambda x: np.logaddexp(x, 0.0),
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
}


def _eval_const(expr, env, line):
    """Eagerly evaluate a transformed-data expression on the host
    (float64 numpy); only data/constants may be referenced."""
    if isinstance(expr, (int, float)):
        return float(expr)
    if isinstance(expr, str):
        if expr in env:
            return np.asarray(env[expr], np.float64)
        raise StanSyntaxError(
            f"transformed data may only reference data, got {expr!r}",
            line=line,
        )
    tag = expr[0]
    if tag == "binop":
        left = _eval_const(expr[2], env, line)
        right = _eval_const(expr[3], env, line)
        if expr[1] == "mul" and getattr(left, "ndim", 0) == 2:
            return left @ right
        ops = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
               "div": np.divide}
        return ops[expr[1]](left, right)
    if tag == "neg":
        return -_eval_const(expr[1], env, line)
    if tag == "call":
        if expr[1] not in _NP_FNS:
            raise StanSyntaxError(f"unknown function {expr[1]!r}", line=line)
        vals = [_eval_const(a, env, line) for a in expr[2]]
        if len(vals) != 1:
            raise StanSyntaxError(
                f"{expr[1]} expects 1 argument, got {len(vals)}", line=line)
        return _NP_FNS[expr[1]](vals[0])
    if tag == "index":
        base = _eval_const(expr[1], env, line)
        idx = _eval_const(expr[2], env, line)
        return base[int(idx) - 1]  # Stan is 1-based
    raise StanSyntaxError(f"bad transformed-data expression {expr!r}",
                          line=line)


def _free_names(expr):
    """Variable names referenced by an expression (function/dist names
    from call/lpdf nodes are NOT variables)."""
    if isinstance(expr, (int, float)):
        return set()
    if isinstance(expr, str):
        return {expr}
    tag = expr[0]
    if tag == "binop":
        return _free_names(expr[2]) | _free_names(expr[3])
    if tag == "neg":
        return _free_names(expr[1])
    if tag == "call":
        out = set()
        for a in expr[2]:
            out |= _free_names(a)
        return out
    if tag == "index":
        base = ({expr[1]} if isinstance(expr[1], str)
                else _free_names(expr[1]))
        return base | _free_names(expr[2])
    if tag == "lpdf":
        out = _free_names(expr[2])
        for a in expr[3]:
            out |= _free_names(a)
        return out
    return set()


def _subst_expr(expr, binding, line):
    """Bind function parameters to argument expressions (capture-free:
    params are the only free names a function body may use via name)."""
    if isinstance(expr, (int, float)):
        return expr
    if isinstance(expr, str):
        return binding.get(expr, expr)
    tag = expr[0]
    if tag == "binop":
        return (tag, expr[1], _subst_expr(expr[2], binding, line),
                _subst_expr(expr[3], binding, line))
    if tag == "neg":
        return (tag, _subst_expr(expr[1], binding, line))
    if tag == "call":
        return (tag, expr[1],
                [_subst_expr(a, binding, line) for a in expr[2]])
    if tag == "index":
        # the base may be a name (possibly bound to an argument or a
        # local's expression — vector locals index fine) or, after a
        # previous substitution, already an expression
        base = expr[1]
        if isinstance(base, str):
            base = binding.get(base, base)
        else:
            base = _subst_expr(base, binding, line)
        return (tag, base, _subst_expr(expr[2], binding, line))
    if tag == "lpdf":
        return (tag, expr[1], _subst_expr(expr[2], binding, line),
                [_subst_expr(a, binding, line) for a in expr[3]])
    raise StanSyntaxError(f"bad expression {expr!r}", line=line)


def _expand_expr(expr, fns, line, stack=()):
    """Inline user-function calls (macro expansion — no call nodes in
    the lowered graph, one fused XLA program). Recursion is rejected."""
    if isinstance(expr, (int, float, str)):
        return expr
    tag = expr[0]
    if tag == "call" and expr[1] in fns:
        f = fns[expr[1]]
        if expr[1] in stack:
            raise StanSyntaxError(
                f"recursive function {expr[1]!r} is not supported",
                line=line)
        args = [_expand_expr(a, fns, line, stack) for a in expr[2]]
        if len(args) != len(f["params"]):
            raise StanSyntaxError(
                f"{expr[1]} expects {len(f['params'])} arguments, got "
                f"{len(args)}", line=line)
        binding = dict(zip(f["params"], args))
        # local declarations substitute in order (later locals may use
        # earlier ones); macro expansion duplicates a reused local's
        # expression, which XLA's CSE collapses back to one computation
        for lname, lexpr in f.get("locals", ()):
            binding[lname] = _subst_expr(lexpr, binding, line)
        body = _subst_expr(f["body"], binding, line)
        return _expand_expr(body, fns, line, stack + (expr[1],))
    if tag == "binop":
        return (tag, expr[1], _expand_expr(expr[2], fns, line, stack),
                _expand_expr(expr[3], fns, line, stack))
    if tag == "neg":
        return (tag, _expand_expr(expr[1], fns, line, stack))
    if tag == "call":
        return (tag, expr[1],
                [_expand_expr(a, fns, line, stack) for a in expr[2]])
    if tag == "index":
        base = (expr[1] if isinstance(expr[1], str)
                else _expand_expr(expr[1], fns, line, stack))
        return (tag, base, _expand_expr(expr[2], fns, line, stack))
    if tag == "lpdf":
        return (tag, expr[1], _expand_expr(expr[2], fns, line, stack),
                [_expand_expr(a, fns, line, stack) for a in expr[3]])
    return expr


def _expand_stmt(stmt, fns):
    kind = stmt.get("kind", "sampling")
    if kind == "sampling":
        return dict(stmt, args=[_expand_expr(a, fns, stmt["line"])
                                for a in stmt["args"]])
    if kind == "target":
        return dict(stmt, expr=_expand_expr(stmt["expr"], fns, stmt["line"]))
    if kind == "for":
        return dict(stmt, body=[_expand_stmt(s, fns) for s in stmt["body"]])
    return stmt


def compile(code: str, data=None):
    """Compile Stan code + data dict to an IR (reference Stan.compile!,
    stan.ex:52-60). Raises StanSyntaxError with line context on failure."""
    data = dict(data or {})
    ast = parse(code)

    # user functions: inline every call site up front (macro expansion)
    user_fns = {}
    for f in ast.get("functions", []):
        if f["name"] in user_fns:
            raise StanSyntaxError(f"duplicate function {f['name']!r}",
                                  line=f["line"])
        if f["name"] in _FNS or f["name"] in _NP_FNS:
            raise StanSyntaxError(
                f"function {f['name']!r} shadows a built-in", line=f["line"])
        seen = set()
        for p in f["params"]:
            if p in seen:
                raise StanSyntaxError(
                    f"duplicate parameter {p!r} in function {f['name']!r}",
                    line=f["line"])
            seen.add(p)
        # bodies are CLOSED over their parameters + locals: a free name
        # would silently bind a same-named model variable at the call
        # site. Locals declare in order — each initializer may only see
        # what precedes it.
        for lname, lexpr in f.get("locals", ()):
            free = _free_names(lexpr) - seen
            if free:
                raise StanSyntaxError(
                    f"local {lname!r} in function {f['name']!r} uses "
                    f"undeclared name(s) {sorted(free)}", line=f["line"])
            seen.add(lname)
        free = _free_names(f["body"]) - seen
        if free:
            raise StanSyntaxError(
                f"function {f['name']!r} uses undeclared name(s) "
                f"{sorted(free)} (bodies may only reference their "
                "parameters and locals)", line=f["line"])
        user_fns[f["name"]] = f
    if user_fns:
        ast["model"] = [_expand_stmt(s, user_fns) for s in ast["model"]]
        for block in ("transformed_data", "transformed_parameters"):
            ast[block] = [
                dict(row, expr=_expand_expr(row["expr"], user_fns,
                                            row["line"]))
                for row in ast[block]
            ]

    data_names = {d["name"] for d in ast["data"]}
    int_data = {
        d["name"]: data[d["name"]]
        for d in ast["data"]
        if d["type"] == "int" and d["name"] in data
    }

    # transformed data: fold eagerly into the data environment
    for row in ast["transformed_data"]:
        data[row["name"]] = _eval_const(row["expr"], data, row["line"])
        data_names.add(row["name"])
        if row["type"] == "int":
            int_data[row["name"]] = int(np.asarray(data[row["name"]]))

    param_decls = {d["name"]: d for d in ast["parameters"]}
    tparam_names = set()

    def _resolve_bound(v, name, line):
        """Bounds may be literals or references to scalar data
        (``real<lower=min_y> y0;``); resolve the latter eagerly."""
        if v is None or isinstance(v, float):
            return v
        if v in data:
            arr = np.asarray(data[v])
            if arr.size != 1:
                raise StanSyntaxError(
                    f"bound {v!r} on {name!r} must be scalar data "
                    f"(got shape {arr.shape})", line=line,
                )
            return float(arr.reshape(()))
        raise StanSyntaxError(
            f"bound {v!r} on {name!r} is not in the data", line=line,
        )

    for d in param_decls.values():
        d["lower"] = _resolve_bound(d.get("lower"), d["name"], d.get("line"))
        d["upper"] = _resolve_bound(d.get("upper"), d["name"], d.get("line"))

    ir = Builder.new_ir()
    declared_rvs = set()
    expr_counter = [0]
    factor_counter = [0]

    def resolve_size(size, line=None):
        if size is None or isinstance(size, int):
            return size
        if size in int_data:
            return int(int_data[size])
        if size in data:
            return int(np.asarray(data[size]))
        raise StanSyntaxError(f"unknown size variable {size!r}", line=line)

    def compile_arg(ir, expr, line):
        """Lower an argument expression AST to a constant or node ref;
        arithmetic compiles to det nodes (extension beyond the
        reference's no-arithmetic limitation, stan.ex:31-36)."""
        if isinstance(expr, float):
            return ir, expr
        if isinstance(expr, str):
            if expr in data_names:
                return ir, np.asarray(data[expr], dtype=np.float32)
            return ir, expr  # ref to another RV/det/transformed param
        tag = expr[0]
        expr_counter[0] += 1
        nid = f"__expr_{expr_counter[0]}"
        if tag == "binop":
            ir, l = compile_arg(ir, expr[2], line)
            ir, r = compile_arg(ir, expr[3], line)
            op = "smul" if expr[1] == "mul" else expr[1]
            ir = Builder.det(ir, nid, op, [l, r])
            return ir, nid
        if tag == "neg":
            ir, x = compile_arg(ir, expr[1], line)
            ir = Builder.det(ir, nid, "neg", [x])
            return ir, nid
        if tag == "call":
            if expr[1] not in _FNS:
                raise StanSyntaxError(
                    f"unknown function {expr[1]!r} (supported: "
                    f"{', '.join(sorted(_FNS))}; user functions are "
                    "inlined before lowering)", line=line,
                )
            if len(expr[2]) != 1:
                raise StanSyntaxError(
                    f"{expr[1]} expects 1 argument, got {len(expr[2])}",
                    line=line)
            ir, x = compile_arg(ir, expr[2][0], line)
            ir = Builder.det(ir, nid, expr[1], [x])
            return ir, nid
        if tag == "index":
            name, idx = expr[1], expr[2]
            if (isinstance(name, str) and name in data_names
                    and isinstance(idx, float)):
                return ir, np.asarray(data[name], np.float32)[int(idx) - 1]
            ir, base = compile_arg(ir, name, line)
            ir, i = compile_arg(ir, idx, line)
            i = i - 1.0 if isinstance(i, float) else i  # Stan is 1-based
            ir = Builder.det(ir, nid, "getitem", [base, i])
            return ir, nid
        if tag == "lpdf":
            # <dist>_lpdf(value | args): summed log-density increment
            dist, pnames = _lookup_dist(expr[1], line)
            if len(expr[3]) != len(pnames):
                raise StanSyntaxError(
                    f"{expr[1]}_lpdf expects {len(pnames)} args, got "
                    f"{len(expr[3])}", line=line,
                )
            ir, value = compile_arg(ir, expr[2], line)
            arg_refs = []
            for a in expr[3]:
                ir, r = compile_arg(ir, a, line)
                arg_refs.append(r)

            def lpdf_fn(v, *ps, _dist=dist, _pn=tuple(pnames)):
                # per chain: the event axes only
                v, params = _align_dist(_dist, v, dict(zip(_pn, ps)))
                return event_sum(_dist.logpdf(v, params))

            ir = Builder.det(ir, nid, _batched(lpdf_fn), [value] + arg_refs)
            return ir, nid
        raise StanSyntaxError(f"bad expression {expr!r}", line=line)

    # transformed parameters: named det nodes
    for row in ast["transformed_parameters"]:
        ir, ref = compile_arg(ir, row["expr"], row["line"])
        ir = Builder.det(ir, row["name"], "identity", [ref])
        tparam_names.add(row["name"])

    def emit_affine(ir, decl, target, dist, param_names, params, line):
        """``<offset=o, multiplier=m>`` affine parameters (Stan manual
        §25.7 — the manual non-centering idiom; round-3 extension beyond
        the reference frontend). Lowering rides the NCP reconstruction
        machinery: the point-map coordinate is the UNCONSTRAINED z with
        an improper Flat prior; ``ncp_info[target] = {mu: o, sigma: m,
        kind: "affine"}`` reconstructs x = o + m*z everywhere x is
        referenced — including the returned trace — and a factor node
        supplies the density ``dist_lpdf(x | args) + sum(log(m))``
        (Stan's Jacobian adjustment, which matters when m is itself a
        parameter: with ``theta<offset=mu, multiplier=tau> ~
        normal(mu, tau)`` the terms cancel to a standard normal on z,
        exactly Stan's NCP)."""
        if decl.get("lower") is not None or decl.get("upper") is not None:
            raise StanSyntaxError(
                "offset/multiplier cannot be combined with lower/upper "
                "bounds", line=line)
        if decl["type"] not in ("real", "vector"):
            raise StanSyntaxError(
                "offset/multiplier is supported for real and vector "
                "parameters", line=line)

        def aff_ref(v, default):
            if v is None:
                return default
            if isinstance(v, float):
                return v
            if v in data_names:
                arr = np.asarray(data[v])
                if arr.ndim != 0 and arr.size != 1:
                    raise StanSyntaxError(
                        f"offset/multiplier data ref {v!r} must be a "
                        "scalar", line=line)
                return float(arr)
            if v in param_decls or v in tparam_names:
                return v  # node ref, resolved by the NCP reconstruction
            raise StanSyntaxError(
                f"offset/multiplier ref {v!r} is neither data nor a "
                "parameter", line=line)

        off = aff_ref(decl.get("offset"), 0.0)
        mult = aff_ref(decl.get("multiplier"), 1.0)
        size = resolve_size(decl.get("size"), line)
        shape = (size,) if size is not None else None

        ir = Builder.rv(ir, target, dists.Flat, {}, shape=shape)
        ir = _replace(ir, ncp_info={
            **ir.ncp_info,
            target: {"mu": off, "sigma": mult, "kind": "affine"},
        })

        def aff_lp(x, m, *ps, _dist=dist, _pn=tuple(param_names)):
            xv, params = _align_dist(_dist, x, dict(zip(_pn, ps)))
            lp = event_sum(_dist.logpdf(xv, params))
            log_m = torch.log(torch.as_tensor(m, dtype=x.dtype, device=x.device))
            # log(m) once per element of x, per chain
            jac = event_sum(log_m.expand(torch.broadcast_shapes(log_m.shape, x.shape)))
            return lp + jac

        nid = f"__{target}_afflp"
        ir = Builder.det(ir, nid + "_val", _batched(aff_lp),
                         [target, mult] + [params[p] for p in param_names])
        fac = dists.Custom(
            logpdf_fn=lambda x, prm: prm["v"], support="real",
        )
        ir = Builder.rv(ir, nid, fac, {"v": nid + "_val"})
        ir = Builder.obs(ir, nid + "_obs", nid, 0.0)
        declared_rvs.add(target)
        return ir

    def emit_sampling(ir, stmt):
        target, dist_name, args = stmt["target"], stmt["dist"], stmt["args"]
        line = stmt["line"]
        if isinstance(target, tuple):
            raise StanSyntaxError(
                f"indexed target {target[1]}[...] is only supported inside "
                "a for loop over the full range (vectorized lowering)",
                line=line,
            )
        dist, param_names = _lookup_dist(dist_name, line)
        if len(args) != len(param_names):
            raise StanSyntaxError(
                f"{dist_name} expects {len(param_names)} args, got {len(args)}",
                line=line,
            )
        params = {}
        for pname, arg in zip(param_names, args):
            ir, val = compile_arg(ir, arg, line)
            params[pname] = val
        if dist_name == "dirichlet" and isinstance(params.get("alpha"), (int, float)):
            raise StanSyntaxError("dirichlet needs a vector alpha", line=line)
        if dist_name == "uniform":
            for k in ("lower", "upper"):
                v = params.get(k)
                if isinstance(v, np.ndarray) and v.size == 1:
                    params[k] = float(v)  # scalar data bound is a constant
                elif not isinstance(v, (int, float)):
                    raise StanSyntaxError(
                        "uniform bounds must be numeric constants "
                        "(non-constant bounds would need a data-dependent "
                        "constraint transform)",
                        line=line,
                    )

        if target in param_decls:
            decl = param_decls[target]
            if (decl.get("offset") is not None
                    or decl.get("multiplier") is not None):
                return emit_affine(ir, decl, target, dist, param_names,
                                   params, line)
            transform = _constraint_transform(decl)
            shape = None
            size = resolve_size(decl.get("size"), line)
            if decl["type"] == "matrix":
                size2 = resolve_size(decl.get("size2"), line)
                shape = (size, size2)  # elementwise prior over the block
            elif size is not None:
                shape = (size,)
            if decl["type"] == "simplex":
                shape = (size,)
            elif decl["type"] in ("ordered", "positive_ordered",
                                  "sum_to_zero_vector",
                                  "cholesky_factor_corr"):
                if transform is not None:
                    # Stan rejects bounds on these types too; silently
                    # dropping a parsed <lower=,upper=> would mis-sample
                    raise StanSyntaxError(
                        f"<lower=/upper=> bounds are not supported on "
                        f"{decl['type']} (the type carries its own "
                        "constraint)", line=line,
                    )
                if decl["type"] == "sum_to_zero_vector":
                    transform = "zero_sum"
                    shape = (size,)
                elif decl["type"] == "cholesky_factor_corr":
                    transform = "cholesky_corr"
                    shape = (size, size)
                else:
                    transform = decl["type"]
                    shape = (size,)
            ir = Builder.rv(ir, target, dist, params, transform=transform,
                            shape=shape)
            declared_rvs.add(target)
        elif target in data_names:
            # data on the left of ~ : RV + obs pair (stan/compiler.ex:61-97)
            rv_id = f"__{target}_rv"
            value = np.asarray(data[target], dtype=np.float32)
            if dist_name in ("categorical", "ordered_logistic"):
                # Stan categorical/ordinal outcomes are 1-indexed
                # (y in 1..K); the dists are 0-indexed
                if value.min() < 1:
                    raise StanSyntaxError(
                        f"{dist_name} data must be 1-indexed (Stan "
                        f"convention); got a value of {value.min()}",
                        line=line,
                    )
                value = value - 1.0
            shape = tuple(value.shape) or None
            ir = Builder.rv(ir, rv_id, dist, params, shape=shape)
            ir = Builder.obs(ir, f"{target}_obs", rv_id, value)
        elif target in tparam_names:
            raise StanSyntaxError(
                f"{target!r} is a transformed parameter; sampling statements "
                "must target a parameter or data", line=line,
            )
        else:
            raise StanSyntaxError(
                f"{target!r} is neither a declared parameter nor data",
                line=line,
            )
        return ir

    def emit_target(ir, stmt):
        ir, ref = compile_arg(ir, stmt["expr"], stmt["line"])
        factor_counter[0] += 1
        nid = f"__factor_{factor_counter[0]}"
        fac = dists.Custom(
            logpdf_fn=lambda x, params: params["v"], support="real",
        )
        ir = Builder.rv(ir, nid, fac, {"v": ref})
        ir = Builder.obs(ir, f"{nid}_obs", nid, 0.0)
        return ir

    def subst_loop_var(expr, var, vec_sizes, line):
        """Vectorizing substitution: x[var] -> x (whole vector); any
        other use of the loop variable is rejected."""
        if isinstance(expr, float):
            return expr
        if isinstance(expr, str):
            if expr == var:
                raise StanSyntaxError(
                    f"loop variable {var!r} may only appear as an index "
                    "x[{0}] (loops lower to whole-vector statements)".format(var),
                    line=line,
                )
            return expr
        tag = expr[0]
        if tag == "index" and expr[2] == var:
            vec_sizes.append(expr[1])
            return expr[1]
        if tag == "binop":
            return (tag, expr[1], subst_loop_var(expr[2], var, vec_sizes, line),
                    subst_loop_var(expr[3], var, vec_sizes, line))
        if tag == "neg":
            return (tag, subst_loop_var(expr[1], var, vec_sizes, line))
        if tag == "call":
            return (tag, expr[1],
                    [subst_loop_var(a, var, vec_sizes, line)
                     for a in expr[2]])
        if tag == "index":
            return (tag, expr[1], subst_loop_var(expr[2], var, vec_sizes, line))
        if tag == "lpdf":
            return (tag, expr[1], subst_loop_var(expr[2], var, vec_sizes, line),
                    [subst_loop_var(a, var, vec_sizes, line) for a in expr[3]])
        raise StanSyntaxError(f"bad expression {expr!r}", line=line)

    def vec_size_of(name, line):
        if name in param_decls:
            return resolve_size(param_decls[name].get("size"), line)
        if name in data_names:
            arr = np.asarray(data[name])
            return arr.shape[0] if arr.ndim else None
        return None  # transformed params: size not statically declared

    def emit_for(ir, stmt):
        """Vectorized loop lowering: the body must index by the loop
        variable over its FULL range 1:N; each body statement emits once
        as a whole-vector statement (the TPU-native answer — no unrolled
        per-element nodes in the graph)."""
        line = stmt["line"]
        lo, hi = stmt["lo"], stmt["hi"]
        if not isinstance(lo, float):
            lo = float(resolve_size(lo, line))
        if isinstance(hi, str):
            hi = float(resolve_size(hi, line))
        if not isinstance(hi, (int, float)):
            raise StanSyntaxError("loop bounds must be constants or data "
                                  "ints", line=line)
        if int(lo) != 1:
            raise StanSyntaxError(
                "only full-range loops 'for (i in 1:N)' are supported "
                "(vectorized lowering)", line=line,
            )
        n = int(hi)
        for body in stmt["body"]:
            kind = body.get("kind", "sampling")
            vec_sizes = []
            if kind == "for":
                raise StanSyntaxError("nested loops are not supported",
                                      line=body["line"])
            if kind == "target":
                new_expr = subst_loop_var(body["expr"], stmt["var"],
                                          vec_sizes, body["line"])
                new_body = dict(body, expr=new_expr)
            else:
                target = body["target"]
                if isinstance(target, tuple):
                    if target[2] != stmt["var"]:
                        raise StanSyntaxError(
                            "indexed targets must use the loop variable",
                            line=body["line"],
                        )
                    vec_sizes.append(target[1])
                    target = target[1]
                new_args = [
                    subst_loop_var(a, stmt["var"], vec_sizes, body["line"])
                    for a in body["args"]
                ]
                new_body = dict(body, target=target, args=new_args)
            for name in vec_sizes:
                size = vec_size_of(name, body["line"])
                if size is not None and size != n:
                    raise StanSyntaxError(
                        f"loop range 1:{n} does not cover {name!r} "
                        f"(length {size}); partial-range loops are not "
                        "supported", line=body["line"],
                    )
            ir = emit_stmt(ir, new_body)
        return ir

    def emit_stmt(ir, stmt):
        kind = stmt.get("kind", "sampling")
        if kind == "sampling":
            return emit_sampling(ir, stmt)
        if kind == "target":
            return emit_target(ir, stmt)
        if kind == "for":
            return emit_for(ir, stmt)
        raise StanSyntaxError(f"unknown statement kind {kind!r}",
                              line=stmt.get("line"))

    for stmt in ast["model"]:
        ir = emit_stmt(ir, stmt)

    missing = set(param_decls) - declared_rvs
    if missing:
        raise StanSyntaxError(
            f"parameters without a sampling statement: {sorted(missing)} "
            "(give each parameter a prior via '~' — priors stated only "
            "through target += are not yet mapped to RV declarations)"
        )
    if ast["generated_quantities"]:
        gq = [dict(row, expr=_expand_expr(row["expr"], user_fns,
                                          row["line"]))
              for row in ast["generated_quantities"]] if user_fns else              ast["generated_quantities"]
        # stash on the IR instance: GQ does not touch the log-density
        # (ir_signature/compile keys unaffected); stan.sample reads it
        ir._stan_gq = {"rows": gq, "data": data,
                       "sizes": {r["name"]: resolve_size(r.get("size"),
                                                         r.get("line"))
                                 for r in gq}}
    return ir


# ---------------------------------------------------------------------------
# generated quantities (evaluated per posterior draw, AFTER sampling)
# ---------------------------------------------------------------------------

_RNG_FNS = {
    "normal_rng": lambda rng, mu, sigma: rng.normal(mu, np.abs(sigma)),
    "student_t_rng": lambda rng, nu, mu, sigma:
        mu + np.abs(sigma) * rng.standard_t(np.broadcast_to(
            nu, np.broadcast_shapes(np.shape(nu), np.shape(mu),
                                    np.shape(sigma)))),
    "lognormal_rng": lambda rng, mu, sigma: rng.lognormal(mu, np.abs(sigma)),
    "exponential_rng": lambda rng, lam: rng.exponential(1.0 / lam),
    "gamma_rng": lambda rng, a, b: rng.gamma(a, 1.0 / b),
    "beta_rng": lambda rng, a, b: rng.beta(a, b),
    "uniform_rng": lambda rng, lo, hi: rng.uniform(lo, hi),
    "bernoulli_rng": lambda rng, p: (rng.random(np.shape(p)) < p)
        .astype(np.float64),
    "bernoulli_logit_rng": lambda rng, eta:
        (rng.random(np.shape(eta)) < 1.0 / (1.0 + np.exp(-eta)))
        .astype(np.float64),
    "poisson_rng": lambda rng, lam: rng.poisson(lam).astype(np.float64),
    "binomial_rng": lambda rng, n, p:
        rng.binomial(np.asarray(n).astype(np.int64), p).astype(np.float64),
}


def _eval_gq(expr, env, rng, line, data_names=frozenset(), size=None):
    # ``size`` applies only to a TOP-LEVEL *_rng call: the declared
    # trailing dimension makes each element an INDEPENDENT draw
    # (post-hoc broadcasting would replicate one draw)
    """Per-draw generated-quantities evaluator (host numpy, float64).

    env values carry leading (chains, draws) axes for parameters and GQ
    rows, and plain shapes for data; broadcasting aligns trailing dims.
    sum/mean reduce the LAST axis (Stan's vector reductions), indexing
    takes on the last axis (1-based), and a 2-d DATA matrix times a
    vector lowers to an einsum over the trailing axis."""
    if isinstance(expr, (int, float)):
        return float(expr)
    if isinstance(expr, str):
        if expr in env:
            return env[expr]
        raise StanSyntaxError(
            f"generated quantities: unknown name {expr!r}", line=line)
    tag = expr[0]
    if tag == "binop":
        left = _eval_gq(expr[2], env, rng, line, data_names)
        right = _eval_gq(expr[3], env, rng, line, data_names)
        if (expr[1] == "mul" and isinstance(expr[2], str)
                and expr[2] in data_names
                and getattr(left, "ndim", 0) == 2):
            # data matrix times a (possibly draw-batched) vector
            return np.einsum("mk,...k->...m", left, right)
        ops = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
               "div": np.divide}
        return ops[expr[1]](left, right)
    if tag == "neg":
        return -_eval_gq(expr[1], env, rng, line, data_names)
    if tag == "call":
        name = expr[1]
        vals = [_eval_gq(a, env, rng, line, data_names) for a in expr[2]]
        if name in _RNG_FNS:
            arrs = [np.asarray(v, np.float64) for v in vals]
            if len(arrs) > 1:
                arrs = list(np.broadcast_arrays(*arrs))
            if size is not None:
                # expand to the declared trailing axis UNLESS the args
                # already carry it: draw-batched args are exactly 2-d
                # (chains, draws) when scalar-per-draw, >= 3-d when the
                # param axis is present; a bare data vector is 1-d.
                # Checking shp[-1] == size alone misfired when the
                # declared size equaled num_samples (code-review r4
                # finding 4: one draw silently replicated per element).
                shp = arrs[0].shape if arrs else ()
                already_sized = ((len(shp) >= 3 and shp[-1] == size)
                                 or (len(shp) == 1 and shp[0] == size))
                if not already_sized:
                    arrs = [np.broadcast_to(a[..., None], shp + (size,))
                            for a in arrs]
            return _RNG_FNS[name](rng, *arrs)
        if name in ("sum", "mean"):
            v = np.asarray(vals[0])
            if len(vals) != 1:
                raise StanSyntaxError(f"{name} expects 1 argument",
                                      line=line)
            return (np.sum if name == "sum" else np.mean)(
                v, axis=-1) if v.ndim else v
        if name in _NP_FNS:
            if len(vals) != 1:
                raise StanSyntaxError(f"{name} expects 1 argument",
                                      line=line)
            return _NP_FNS[name](vals[0])
        raise StanSyntaxError(
            f"generated quantities: unknown function {name!r} "
            f"(supported: arithmetic, {sorted(_NP_FNS)}, "
            f"{sorted(_RNG_FNS)})", line=line)
    if tag == "index":
        base = np.asarray(_eval_gq(expr[1], env, rng, line, data_names))
        idx = _eval_gq(expr[2], env, rng, line, data_names)
        return np.take(base, int(idx) - 1, axis=-1)  # Stan is 1-based
    raise StanSyntaxError(f"bad generated-quantities expression {expr!r}",
                          line=line)


def generated_quantities(ir, trace, seed=0):
    """Evaluate a compiled model's ``generated quantities`` block over a
    posterior trace (reference has no GQ; Stan evaluates per draw after
    sampling — here each row evaluates VECTORIZED over the whole
    (chains, draws) batch in one numpy pass). Returns {name: array
    with leading (chains, draws)}. Rows may reference data, parameters,
    transformed parameters present in the trace, and earlier GQ rows;
    ``*_rng`` calls draw fresh randomness per chain/draw."""
    gq = getattr(ir, "_stan_gq", None)
    if not gq:
        return {}
    rng = np.random.default_rng(seed)
    env = {k: np.asarray(v, np.float64) for k, v in gq["data"].items()}
    data_names = frozenset(env)
    c = n = None
    for k, v in trace.items():
        arr = np.asarray(v, np.float64)
        env[k] = arr
        c, n = arr.shape[:2]
    out = {}
    for row in gq["rows"]:
        name, line = row["name"], row.get("line")
        if name in env:
            raise StanSyntaxError(
                f"generated quantity {name!r} shadows an existing name",
                line=line)
        size = gq["sizes"].get(name)
        val = np.asarray(
            _eval_gq(row["expr"], env, rng, line, data_names, size=size),
            np.float64)
        want = (c, n) + ((size,) if size else ())
        if val.shape != want:
            if size and val.shape == want[:-1]:
                # deterministic scalar expression under a vector
                # declaration: replicate (no randomness involved here —
                # rng rows were drawn at the declared size above)
                val = np.broadcast_to(val[..., None], want)
            else:
                try:
                    val = np.broadcast_to(val, want)
                except ValueError:
                    raise StanSyntaxError(
                        f"generated quantity {name!r} has shape "
                        f"{val.shape}, declared {want}", line=line
                    ) from None
        env[name] = val
        out[name] = val
    return out


def compile_or_error(code, data=None):
    """Non-raising variant: returns ("ok", ir) or ("error", message)."""
    try:
        return "ok", compile(code, data)
    except (StanSyntaxError, KeyError) as e:  # pragma: no cover
        return "error", str(e)


def sample(code, data=None, **opts):
    """Compile-and-sample (reference Stan.sample, stan.ex:77) on
    ``device`` (an option; default ``"cuda"``). When the program has a
    ``generated quantities`` block, its rows are evaluated over the
    posterior and merged into the returned trace."""
    from exmc_tpu_torch.nuts.sampler import sample as nuts_sample

    ir = compile(code, data)
    trace, stats = nuts_sample(ir, **opts)
    gq = generated_quantities(ir, trace, seed=opts.get("seed", 0))
    if gq:
        trace = dict(trace, **gq)
    return trace, stats
