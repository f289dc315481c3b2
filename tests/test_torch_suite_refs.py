"""The JAX package's reference posteriors of the seven-model suite, which
``exmc_tpu_torch.benchmarks.suite.REFERENCES`` stores as constants (the
port never imports JAX to get them).

Regenerate them on the CPU with

    JAX_PLATFORMS=cpu python tests/test_torch_suite_refs.py [model ...]

which runs each model under the suite recipe with the JAX package's
sampler at ``SETTINGS`` and prints ``REFERENCE_SETTINGS`` and
``REFERENCES`` to paste into the port. The tests below check the
generator at a small size, the recipe against the JAX package's script,
and the stored constants against known values."""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script from any directory
    sys.path.insert(0, str(ROOT))

from exmc_tpu.benchmarks import suite as jsuite  # noqa: E402
from exmc_tpu.nuts.sampler import _make_sampler  # noqa: E402
from exmc_tpu_torch.benchmarks import suite as tsuite  # noqa: E402

SETTINGS = {"chains": 32, "warmup": 1000, "draws": 2000, "seed": 1}


def jax_reference(name, chains, warmup, draws, seed):
    """{quantity: (mean, sd, MCSE)} of the model's gate quantities from one
    JAX-package run under the suite recipe."""
    recipe = tsuite.SUITE_RECIPE[name]
    sampler = _make_sampler(jsuite.build_model(name), ncp=recipe["ncp"],
                            num_warmup=warmup, num_samples=draws,
                            **recipe["opts"])
    trace, _ = sampler.run(num_chains=chains, seed=seed)
    return tsuite.posterior_summary(
        name, {k: np.asarray(v) for k, v in trace.items()})


def _load_suite_script():
    spec = importlib.util.spec_from_file_location(
        "run_suite_bench", ROOT / "scripts" / "run_suite_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recipe_is_the_jax_scripts():
    script = _load_suite_script()
    assert sorted(tsuite.SUITE_RECIPE) == sorted(script.CHAINS)
    for name, r in tsuite.SUITE_RECIPE.items():
        assert r["chains"] == script.CHAINS[name]
        assert r["ncp"] == script.NCP[name]
        assert r["opts"] == script.EXTRA_OPTS.get(name, {})


def test_reference_generator_small():
    ref = jax_reference("simple", chains=2, warmup=30, draws=30, seed=0)
    assert sorted(ref) == sorted(tsuite.GATE_PARAMS["simple"])
    for mean, sd, mcse in ref.values():
        assert np.isfinite(mean) and sd > 0 and mcse > 0


def test_stored_references_complete_and_plausible():
    """Every model has its reference at the stated settings; eight
    schools' tau matches 2-d quadrature (3.284,
    scripts/run_suite_bench.py:70-72) and logistic's alpha sits near its
    true 0.5 (tests/test_suite_models.py:45-50)."""
    assert tsuite.REFERENCE_SETTINGS == SETTINGS
    assert sorted(tsuite.REFERENCES) == sorted(tsuite.MODELS)
    for name, ref in tsuite.REFERENCES.items():
        assert sorted(ref) == sorted(tsuite.GATE_PARAMS[name])
        for mean, sd, mcse in ref.values():
            assert np.isfinite(mean) and sd > 0 and 0 < mcse < sd
    tau, _, mcse = tsuite.REFERENCES["eight_schools"]["tau"]
    assert abs(tau - 3.284) < 0.05 + 4 * mcse
    assert abs(tsuite.REFERENCES["logistic"]["alpha"][0] - 0.5) < 0.5


def main(names):
    refs = {}
    for name in names or list(tsuite.MODELS):
        refs[name] = jax_reference(name, **SETTINGS)
        print(f"# {name}: {json.dumps(refs[name])}", flush=True)
    print(f"REFERENCE_SETTINGS = {SETTINGS!r}")
    print("REFERENCES = {")
    for name, ref in refs.items():
        print(f"    {name!r}: {{")
        for q, (m, sd, mcse) in ref.items():
            print(f"        {q!r}: ({m!r}, {sd!r}, {mcse!r}),")
        print("    },")
    print("}")


if __name__ == "__main__":
    main(sys.argv[1:])
