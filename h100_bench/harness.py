"""One run of one cell: set-up, a window of whole fits through
``exmc_tpu_torch.sample``, the comparison with the cell's reference, the
per-layer readers, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the file the configuration names) and
  ``configs/<config>.py`` beside it, whose ``build(cfg, seed, device)``
  returns the model's IR and the data arrays the reference reads;
- ``reference/<config>.py``: ``unconstrain``, ``logp_and_grad``,
  ``posterior`` and ``CONTROL``;
- ``traffic/<traffic>.json``: engine, chains, warmup, draws, init,
  options, the set-up's warm-up fit and the traced run's profiled fit
  (null: a whole fit of the recipe);
- ``limits/<cell>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: ``read(run)`` of one per-layer metric, which
  returns None where it finds nothing to read.
"""

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from h100_bench import ess as ess_lib

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "exmc_tpu")
# the set-up's warm-up fit takes this fit index
WARM_UP_FIT = 999


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "h100_bench._" + path.stem.replace(".", "_") + "_" + path.parent.name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fit_seed(seed, k):
    """The seed of the window's fit ``k``."""
    return 1000 * int(seed) + k


@dataclass
class Spec:
    """One cell as ``BENCHMARK.json`` and its files state it."""

    bench: dict
    cell: dict
    cfg: dict
    cfg_path: Path
    traffic: dict
    limits: dict

    @classmethod
    def load(cls, root, workload):
        bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r} (one of {sorted(cells)})")
        cell = cells[workload]
        config = next(c for c in bench["configs"] if c["name"] == cell["config"])
        cfg_path = Path(root) / config["file"]
        return cls(bench=bench, cell=cell, cfg=json.loads(cfg_path.read_text()),
                   cfg_path=cfg_path,
                   traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
                   limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()))

    def per_layer(self):
        """The per-layer metrics this cell reports."""
        name = self.cell["name"]
        return [m for m in self.bench["per_layer"]
                if name in m.get("workloads", [name])]

    def end_to_end(self):
        return self.bench["end_to_end"]


@dataclass
class Fit:
    """One whole fit of the window."""

    seconds: float
    trace: dict
    stats: dict
    host_syncs: int = None
    iterations: int = None
    ess: dict = field(default_factory=dict)

    @property
    def min_ess(self):
        return min(self.ess.values())

    @property
    def n_steps(self):
        return int(np.asarray(self.stats["n_steps"]).sum())


@dataclass
class Run:
    """What the readers of per-layer metrics read."""

    spec: Spec
    config: object          # the configuration's builder module
    fits: list
    device: str
    profile: dict = None    # the device trace of the profiled fit
    _values: dict = field(default_factory=dict)

    @property
    def chains(self):
        return self.spec.traffic["chains"]

    def value(self, name):
        """The reading of per-layer metric ``name`` (None: nothing to read)."""
        if name not in self._values:
            self._values[name] = load_module(HERE / "metrics" / f"{name}.py").read(self)
        return self._values[name]


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _is_finite(trace, stats):
    return (all(np.isfinite(np.asarray(v)).all() for v in trace.values())
            and np.isfinite(np.asarray(stats["logp"])).all())


def _pack(entries, umap, lead):
    """{name: (*lead, *ushape)} -> (*lead, d) in the program's flat layout."""
    return np.concatenate([np.asarray(umap[e.id]).reshape(*lead, e.length)
                           for e in entries], axis=-1)


def _unpack(entries, flat, like):
    """(n, d) -> {name: (n, *ushape)} shaped as ``like``'s arrays."""
    return {e.id: flat[:, e.offset:e.offset + e.length].reshape(like[e.id].shape)
            for e in entries}


class Program:
    """The system under test: the model built from the seed, the cached
    sampler that ``exmc_tpu_torch.sample`` finds, and the fits."""

    def __init__(self, spec, seed, device):
        import exmc_tpu_torch
        from exmc_tpu_torch.nuts.sampler import _make_sampler

        tr = spec.traffic
        if tr["engine"] != "nuts":
            raise ValueError(f"engine {tr['engine']!r}: the harness drives NUTS fits only "
                             "(their host syncs, draws' steps and value-and-grad are read "
                             "from the cached NUTS sampler)")
        self.sample = exmc_tpu_torch.sample
        self.spec, self.seed, self.device = spec, seed, device
        self.config = load_module(spec.cfg_path.with_suffix(".py"))
        self.ir, self.data = self.config.build(spec.cfg, seed, device)
        self.opts = dict(num_warmup=tr["warmup"], num_samples=tr["draws"], **tr["options"])
        self.init = tuple(tr["init"]) if isinstance(tr["init"], list) else tr["init"]
        # the sampler that every sample() call of the window finds in the
        # cache: its model and CUDA graphs are built here
        self.sampler = _make_sampler(self.ir, device=device, **self.opts)

    def short_fit(self, key, k):
        """A fit of the traffic's ``key`` iterations ([warmup, draws]) on
        the cached sampler's model, at the window's chains and options;
        where the traffic names none, a whole fit of the recipe."""
        tr = self.spec.traffic
        short = tr.get(key)
        if short:
            from exmc_tpu_torch import NUTSSampler

            opts = dict(self.opts, num_warmup=short[0], num_samples=short[1])
            NUTSSampler(model=self.sampler.model, **opts).run(
                num_chains=tr["chains"], seed=fit_seed(self.seed, k), init=self.init)
        else:
            self.fit(k)
        _sync(self.device)

    def warm_up(self):
        """The set-up's fit, which captures every graph the window replays."""
        self.short_fit("warm_up_fit", WARM_UP_FIT)

    def fit(self, k):
        """Whole fit ``k`` of the recipe; returns a Fit."""
        tr = self.spec.traffic
        before = self.sampler.last_run
        t = time.perf_counter()
        trace, stats = self.sample(self.ir, num_chains=tr["chains"],
                                   seed=fit_seed(self.seed, k), init=self.init,
                                   device=self.device, engine="nuts", **self.opts)
        _sync(self.device)
        seconds = time.perf_counter() - t
        if self.sampler.last_run is before:
            raise RuntimeError("the window's fit did not run on the cached sampler "
                               "that set-up built")
        return Fit(seconds=seconds, trace=trace, stats=stats,
                   host_syncs=int(self.sampler.last_run["host_syncs"]),
                   iterations=int(self.sampler.last_run["iterations"]))

    @property
    def dtype(self):
        from exmc_tpu_torch.config import default_dtype

        return default_dtype()

    @property
    def entries(self):
        return self.sampler.model.pm.entries

    def grads_at(self, umap):
        """The program's gradient at the unconstrained points ``umap``
        ({name: (chains, draws, *ushape)}), one batch of the window's
        chains per draw index, as the window calls it: (chains * draws,
        d) float64."""
        import torch

        first = next(iter(umap.values()))
        c, s = first.shape[:2]
        flat = torch.as_tensor(_pack(self.entries, umap, (c, s)), dtype=self.dtype,
                               device=self.device)
        vag = self.sampler.model.value_and_grad
        gs = [vag(flat[:, j].contiguous())[1] for j in range(s)]
        return torch.stack(gs, 1).reshape(c * s, -1).double().cpu().numpy()

    def free(self):
        """Drop the program's state: the sampler cache, the model, the
        data on the card."""
        from exmc_tpu_torch.nuts.sampler import clear_sampler_cache

        self.sampler = None
        self.ir = None
        clear_sampler_cache()
        gc.collect()
        if str(self.device).startswith("cuda"):
            import torch

            torch.cuda.empty_cache()


def _flat(a, lead):
    a = np.asarray(a)
    return a.reshape((lead,) + a.shape[2:])


def compare(spec, fits, data, prog_grads, device, precision="float64"):
    """The numbers compared, each the worst over the window's fits:

    - ``logp_gap``: nats between the log-density the program reported
      for each draw and the reference's at that draw, beyond what the
      rounding of the reported draw to the trace's precision can move
      it (the reference's ``rounding_allowance``);
    - ``grad_gap``: the program's gradient at each draw against the
      reference's, the norm of their difference over the larger of the
      reference's norm there and its median norm;
    - ``mean_z``: each parameter's posterior mean against the
      reference's, in standard errors: the reference's sd over the
      square root of the fit's bulk ESS of that parameter, together
      with the reference's own error where it samples;
    - ``sd_gap``: each parameter's posterior sd over the reference's,
      less 1, in absolute value.

    ``prog_grads`` is a list of the program's {name: gradient} per fit,
    or None to
    read the reference in ``precision`` in the program's place (the
    control): its log-density is then judged in place of the reported
    one and its gradient in place of the program's."""
    ref = load_module(HERE / "reference" / f"{spec.cell['config']}.py")
    post = ref.posterior(data, spec.cfg, seed=0, device=device)
    out = {"logp_gap": 0.0, "grad_gap": 0.0, "mean_z": 0.0, "sd_gap": 0.0}
    for i, fit in enumerate(fits):
        u = ref.unconstrain(fit.trace, data, spec.cfg)
        c, s = np.asarray(fit.stats["logp"]).shape
        uf = {k: _flat(v, c * s) for k, v in u.items()}
        lp_ref, g_ref = ref.logp_and_grad(uf, data, spec.cfg, "float64", device)
        if prog_grads is None:
            lp_prog, g_prog = ref.logp_and_grad(uf, data, spec.cfg, precision, device)
        else:
            lp_prog = np.asarray(fit.stats["logp"], np.float64).reshape(-1)
            g_prog = prog_grads[i]
        eps = np.finfo(np.asarray(fit.stats["logp"]).dtype).eps / 2.0
        allowance = ref.rounding_allowance({k: _flat(v, c * s) for k, v in fit.trace.items()},
                                           g_ref, data, spec.cfg, eps)
        gap = np.maximum(np.abs(lp_prog - lp_ref) - allowance, 0.0)
        out["logp_gap"] = max(out["logp_gap"], float(np.max(gap)))
        names = sorted(g_ref)
        gr = np.concatenate([g_ref[k].reshape(c * s, -1) for k in names], 1)
        gp = np.concatenate([np.asarray(g_prog[k]).reshape(c * s, -1) for k in names], 1)
        norm = np.linalg.norm(gr, axis=1)
        gap = np.linalg.norm(gp - gr, axis=1) / np.maximum(norm, np.median(norm))
        out["grad_gap"] = max(out["grad_gap"], float(np.max(gap)))
        for name, (mean, sd, se_ref) in post.items():
            draws = np.asarray(fit.trace[name], np.float64)
            cols = draws.reshape(c, s, -1)
            mean, sd = np.ravel(mean), np.ravel(sd)
            se_ref = np.broadcast_to(se_ref, mean.shape)
            for j in range(cols.shape[2]):
                label = name if draws.ndim == 2 else f"{name}[{j}]"
                x = cols[:, :, j]
                se = math.sqrt(sd[j] ** 2 / fit.ess[label] + se_ref[j] ** 2)
                out["mean_z"] = max(out["mean_z"], float(abs(x.mean() - mean[j]) / se))
                out["sd_gap"] = max(out["sd_gap"], float(abs(x.std(ddof=1) / sd[j] - 1.0)))
    return out


def _device_info(device, chips, peak):
    import torch

    if not str(device).startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def run_cell(spec, seed, seconds, trace, device="cuda", t0=None, keep=None):
    """Set-up, window, comparison and readings of one run. Returns
    (result, compared): the result line's object without ``compared``,
    and {number: (value, limit)}. A ``keep`` dict receives the fits and
    the data, for readings of the control."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cuda = str(device).startswith("cuda")
    prog = Program(spec, seed, device)
    prog.warm_up()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    fits, failed, k = [], 0, 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        try:
            fit = prog.fit(k)
        except (RuntimeError, ValueError, FloatingPointError) as e:
            print(f"fit {k} failed: {type(e).__name__}: {e}", file=sys.stderr)
            failed += 1
            k += 1
            break
        if not _is_finite(fit.trace, fit.stats):
            failed += 1
        fits.append(fit)
        k += 1
    window_s = time.perf_counter() - start
    attempted = k

    for fit in fits:
        fit.ess = {label: ess_lib.ess_bulk(x) for label, x in
                   ess_lib.scalar_columns(fit.trace)}

    run = Run(spec=spec, config=prog.config, fits=fits, device=device)
    if trace and fits:
        from h100_bench import device_trace

        run.profile = device_trace.profiled(lambda: prog.short_fit("profile_fit", k), device)
        if run.profile is not None:
            print(f"profiled fit: {run.profile['kernels']} device operations, "
                  f"{run.profile['graph_launches']} graph launches, "
                  f"{run.profile['window_s']:.3f} s, reduced in "
                  f"{run.profile['reduce_s']:.3f} s", file=sys.stderr)
    ref = load_module(HERE / "reference" / f"{spec.cell['config']}.py")
    prog_grads = []
    for fit in fits:
        u = ref.unconstrain(fit.trace, prog.data, spec.cfg)
        c, s = np.asarray(fit.stats["logp"]).shape
        g = prog.grads_at(u)
        prog_grads.append(_unpack(prog.entries, g, {n: _flat(v, c * s) for n, v in u.items()}))
    readings = {}
    if trace:
        for m in spec.per_layer():
            v = run.value(m["name"])
            if v is not None:
                readings[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s}
        if fits:
            values["fit_s"] = window_s / len(fits)
            values["ess_per_s"] = sum(f.min_ess for f in fits) / window_s
        for m in spec.end_to_end():
            if m["name"] in values:
                readings[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    data = prog.data
    prog.free()
    if keep is not None:
        keep.update(fits=fits, data=data)

    compared = {}
    if fits:
        numbers = compare(spec, fits, data, prog_grads, device)
        compared = {k: (v, spec.limits[k]) for k, v in numbers.items()}
    correct = (failed == 0 and bool(fits) and bool(compared)
               and all(v <= lim for v, lim in compared.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": readings, "device": _device_info(device, spec.cell["chips"], peak)}
    if trace and run.profile is not None:
        result["device"]["busy_s"] = run.profile["busy_s"]
        result["device"]["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    return result, compared


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the run must not hold,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, root, t0):
    import argparse

    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec.load(root, args.workload)

    import torch

    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, compared = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                                device="cuda", t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may load neither JAX nor the "
              "JAX package", file=sys.stderr)
        return 4
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
