"""Command-line interface of the port: ``python -m exmc_tpu_torch <cmd>``
(``exmc_tpu/__main__.py``), a CmdStan-shaped surface over the Stan
frontend:

    python -m exmc_tpu_torch sample model.stan --data data.json \
        --chains 4 --warmup 1000 --samples 1000 --output fit.npz
    python -m exmc_tpu_torch check model.stan --data data.json
    python -m exmc_tpu_torch summary fit.npz

    python -m exmc_tpu_torch sample model.stan --data data.json \
        --engine chees --chains 64 --output fit.npz
    python -m exmc_tpu_torch optimize model.stan --data data.json
    python -m exmc_tpu_torch variational model.stan --data data.json \
        --output advi.npz

``sample``, ``optimize``, ``variational`` and ``check`` run on the CUDA
card unless ``--device cpu`` is given. ``--engine`` picks NUTS (default)
or the ensemble engines ChEES, SNAPER and MEADS; ``optimize`` prints the
MAP point and exits 1 when L-BFGS did not converge; ``variational`` fits
mean-field ADVI with Adam. Data files are CmdStan-style JSON: {"N": 8,
"y": [...], ...}. Fits are written either as .npz (posterior/<name> +
sample_stats/<name> arrays, compact, lossless) or .json (nested lists,
interoperable), the JAX package's layout, so either CLI's ``summary``
reads the other's fits.
"""

import argparse
import json
import sys

import numpy as np


def _load_data(path):
    if path is None:
        return None
    from exmc_tpu_torch.config import default_dtype

    with open(path) as f:
        raw = json.load(f)
    dtype = np.dtype(str(default_dtype()).removeprefix("torch."))
    out = {}
    for k, v in raw.items():
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, int):
            out[k] = v  # int data stays int (array sizes, counts)
        else:
            out[k] = np.asarray(v, dtype=dtype)
    return out


def _save_fit(path, groups):
    """groups = {"posterior": {...}, "sample_stats": {...}} of arrays."""
    if path.endswith(".json"):
        payload = {
            g: {k: np.asarray(v).tolist() for k, v in d.items()}
            for g, d in groups.items()
        }
        with open(path, "w") as f:
            json.dump(payload, f)
    else:
        flat = {
            f"{g}/{k}": np.asarray(v)
            for g, d in groups.items()
            for k, v in d.items()
        }
        np.savez_compressed(path, **flat)


def _load_fit(path):
    if path.endswith(".json"):
        with open(path) as f:
            payload = json.load(f)
        return {
            g: {k: np.asarray(v) for k, v in d.items()}
            for g, d in payload.items()
        }
    groups = {}
    with np.load(path) as z:
        for key in z.files:
            g, _, k = key.partition("/")
            groups.setdefault(g, {})[k] = z[key]
    return groups


def _print_fit_report(trace, stats):
    from exmc_tpu_torch.trace_utils import summary_table

    print(summary_table(trace))
    if "diverging" in stats:
        div = np.asarray(stats["diverging"])
        total = int(div.sum())
        rate = float(div.mean()) if div.size else 0.0
        print(f"\ndivergences: {total} ({100 * rate:.2f}%)")
    if "rescues" in stats:
        resc = int(np.asarray(stats["rescues"]).sum())
        if resc:
            print(f"warmup rescues: {resc}")


def _cmd_sample(args):
    from exmc_tpu_torch.stan import frontend
    from exmc_tpu_torch.trace_utils import to_inference_dict

    with open(args.model) as f:
        code = f.read()
    data = _load_data(args.data)
    # unset tuning flags are omitted, so each engine keeps its own
    # defaults (NUTS: warmup 1000, target_accept 0.8; ChEES/SNAPER/MEADS:
    # warmup 500, ChEES target_accept 0.651, MEADS self-tuning)
    opts = dict(
        num_chains=args.chains,
        num_samples=args.samples,
        seed=args.seed,
        ncp=not args.no_ncp,
        device=args.device,
    )
    if args.warmup is not None:
        opts["num_warmup"] = args.warmup
    if args.engine != "nuts":
        opts["engine"] = args.engine
    if args.target_accept is not None:
        if args.engine == "meads":
            print("note: --target-accept is ignored by engine 'meads' "
                  "(self-tuning GHMC)", file=sys.stderr)
        else:
            opts["target_accept"] = args.target_accept
    if args.max_depth is not None:
        if args.engine == "nuts":
            opts["max_tree_depth"] = args.max_depth
        else:
            print(f"note: --max-depth is ignored by engine "
                  f"{args.engine!r}", file=sys.stderr)
    trace, stats = frontend.sample(code, data, **opts)
    _print_fit_report(trace, stats)
    if args.output:
        groups = to_inference_dict(trace, stats)
        if not isinstance(groups, dict):  # arviz installed -> InferenceData
            groups = {
                "posterior": {
                    k: np.asarray(v)
                    for k, v in groups.posterior.data_vars.items()
                },
                "sample_stats": {
                    k: np.asarray(v)
                    for k, v in groups.sample_stats.data_vars.items()
                },
            }
        _save_fit(args.output, groups)
        print(f"wrote {args.output}")
    return 0


def _cmd_optimize(args):
    from exmc_tpu_torch.optimize import fit_map
    from exmc_tpu_torch.stan import frontend

    with open(args.model) as f:
        code = f.read()
    ir = frontend.compile(code, _load_data(args.data))
    point, info = fit_map(ir, seed=args.seed, jacobian=args.jacobian,
                          max_iters=args.iters, device=args.device)
    status = "converged" if info["converged"] else "NOT CONVERGED"
    print(f"MAP ({status} in {info['iters']} iters, "
          f"logp={info['logp']:.4f}, |grad|={info['grad_norm']:.2e})")
    w = max(len(k) for k in point) + 2 if point else 0
    for k in sorted(point):
        v = np.asarray(point[k])
        val = f"{float(v):.6g}" if v.shape == () else np.array2string(
            v, precision=4, separator=", ")
        print(f"{k:<{w}}{val}")
    return 0 if info["converged"] else 1


def _cmd_variational(args):
    from exmc_tpu_torch.advi import advi_fit
    from exmc_tpu_torch.stan import frontend

    with open(args.model) as f:
        code = f.read()
    ir = frontend.compile(code, _load_data(args.data))
    fit = advi_fit(ir, num_steps=args.iters, seed=args.seed,
                   num_draws=args.draws, optimizer="adam", device=args.device)
    print(f"ADVI: converged_at={fit.get('converged_at')}")
    trace = fit["draws"]
    _print_fit_report(trace, {})
    if args.output:
        _save_fit(args.output, {"posterior": {
            k: np.asarray(v) for k, v in trace.items()}})
        print(f"wrote {args.output}")
    return 0


def _cmd_check(args):
    from exmc_tpu_torch.compiler import compile_logp
    from exmc_tpu_torch.stan import frontend

    with open(args.model) as f:
        code = f.read()
    status, result = frontend.compile_or_error(code, _load_data(args.data))
    if status == "error":
        print(f"FAIL: {result}", file=sys.stderr)
        return 1
    model = compile_logp(result, device=args.device)
    print(f"OK: {args.model}")
    print(f"unconstrained dimension: {model.size}")
    if model.pm.entries:
        w = max(len(e.id) for e in model.pm.entries) + 2
        print(f"{'parameter':<{w}}{'shape':>10}{'offset':>8}  transform")
        for e in model.pm.entries:
            tname = getattr(e.transform, "name", e.transform) or "-"
            print(f"{e.id:<{w}}{str(e.shape or '()'):>10}{e.offset:>8}  "
                  f"{tname}")
    n_obs = sum(
        1 for n in model.ir.nodes.values() if n.op[0] in ("obs", "meas_obs")
    )
    print(f"observation terms: {n_obs}")
    if model.ncp_info:
        print(f"auto-NCP applied to: {sorted(model.ncp_info)}")
    return 0


def _cmd_summary(args):
    # a saved fit's summary is a few FFTs over small host arrays, on the CPU
    groups = _load_fit(args.fit)
    _print_fit_report(
        groups.get("posterior", {}),
        {"diverging": groups.get("sample_stats", {}).get(
            "diverging", np.zeros(1))},
    )
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m exmc_tpu_torch",
        description="probabilistic programming on a CUDA card (Stan frontend)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sample", help="compile a Stan program and sample")
    p.add_argument("model", help=".stan file")
    p.add_argument("--data", help="CmdStan-style JSON data file")
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--warmup", type=int, default=None,
                   help="warmup iterations (default 1000)")
    p.add_argument("--samples", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target-accept", type=float, default=None,
                   help="(default 0.8)")
    p.add_argument("--max-depth", type=int, default=None,
                   help="NUTS max tree depth (default 10)")
    p.add_argument("--no-ncp", action="store_true",
                   help="disable automatic non-centered parameterization")
    p.add_argument("--engine", default="nuts",
                   choices=["nuts", "chees", "snaper", "meads"],
                   help="nuts (default), or the lockstep ensemble engines")
    p.add_argument("--output", help="write fit to .npz or .json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_sample)

    p = sub.add_parser("optimize", help="MAP point estimate (Stan optimize)")
    p.add_argument("model", help=".stan file")
    p.add_argument("--data", help="CmdStan-style JSON data file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--jacobian", action="store_true",
                   help="include constraint-transform Jacobian terms "
                        "(Stan default is off)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_optimize)

    p = sub.add_parser("variational", help="mean-field ADVI (Stan variational)")
    p.add_argument("model", help=".stan file")
    p.add_argument("--data", help="CmdStan-style JSON data file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=5000)
    p.add_argument("--draws", type=int, default=1000)
    p.add_argument("--output", help="write fit to .npz or .json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_variational)

    p = sub.add_parser("check", help="compile-check a Stan program")
    p.add_argument("model", help=".stan file")
    p.add_argument("--data", help="CmdStan-style JSON data file")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_check)

    p = sub.add_parser("summary", help="summarize a saved fit")
    p.add_argument("fit", help=".npz or .json written by sample --output")
    p.set_defaults(fn=_cmd_summary)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
