"""The port's public names: every subpackage's ``__all__`` holds the JAX
package's names (the port keeps its extras: ``particle`` at the top
level, ``NUTSSampler`` and ``nuts_transition`` in ``nuts``);
``nuts.build_nuts_kernel`` and ``config.backend_info``; and the
application and native modules stand alone (no JAX, nothing of the JAX
package)."""

import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUBPACKAGES = ["", "apps.physics", "apps.poker", "benchmarks", "dists", "nuts", "ops",
               "parallel", "particle", "stan", "utils"]


def _pair(sub):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module(f"exmc_tpu{suffix}"),
            importlib.import_module(f"exmc_tpu_torch{suffix}"))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_all_holds_the_jax_packages_names(sub):
    jmod, tmod = _pair(sub)
    missing = set(jmod.__all__) - set(tmod.__all__)
    assert not missing, f"exmc_tpu_torch.{sub} lacks {sorted(missing)}"
    assert len(tmod.__all__) == len(set(tmod.__all__))
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name


def test_the_ports_extras_stay_and_counts():
    import exmc_tpu_torch
    from exmc_tpu_torch import benchmarks, nuts
    from exmc_tpu_torch.apps import physics, poker

    assert "particle" in exmc_tpu_torch.__all__
    assert {"NUTSSampler", "nuts_transition"} <= set(nuts.__all__)
    assert (len(set(nuts.__all__) - {"NUTSSampler", "nuts_transition"}), len(benchmarks.__all__),
            len(physics.__all__), len(poker.__all__)) == (12, 4, 6, 9)
    assert poker.cards.__name__ == "exmc_tpu_torch.apps.poker.cards"


def test_native_has_the_jax_bindings_names():
    from exmc_tpu import native as jnative
    from exmc_tpu_torch import native

    for name in ("available", "build_full_tree"):
        assert callable(getattr(jnative, name)) and callable(getattr(native, name))


def test_backend_info_has_the_jax_keys():
    from exmc_tpu import config as jconfig
    from exmc_tpu_torch import config

    info = config.backend_info(device="cpu")
    assert set(jconfig.backend_info()) <= set(info)
    assert info["platform"] == "cpu" and info["num_devices"] == 1
    assert info["devices"] == ["cpu"]
    assert info["x64"] is False and info["default_dtype"] == "float32"
    with config.x64():
        assert config.backend_info(device="cpu")["default_dtype"] == "float64"


@pytest.mark.gpu
def test_backend_info_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from exmc_tpu_torch import config

    info = config.backend_info()
    assert info["platform"] == "gpu"
    assert info["num_devices"] == torch.cuda.device_count()
    assert info["devices"][0] == torch.cuda.get_device_name(0)


def test_build_nuts_kernel_equals_nuts_transition_on_injected_draws():
    from exmc_tpu_torch.nuts import build_nuts_kernel, nuts_transition
    from exmc_tpu_torch.nuts.leapfrog import make_metric

    def vag(q):
        return -0.5 * torch.sum(q * q * torch.tensor([1.0, 4.0, 0.25]), dim=-1), \
            -q * torch.tensor([1.0, 4.0, 0.25])

    c, d, depth = 6, 3, 5
    rng = np.random.default_rng(3)
    rand = {"r0_z": torch.as_tensor(rng.normal(size=(c, d)), dtype=torch.float32),
            "go_right": torch.as_tensor(rng.random((c, depth)) < 0.5),
            "merge_logu": -torch.as_tensor(rng.exponential(size=(c, depth)),
                                           dtype=torch.float32),
            "leaf_logu": -torch.as_tensor(rng.exponential(size=(c, depth, 2 ** (depth - 1))),
                                          dtype=torch.float32)}
    q = torch.as_tensor(rng.normal(size=(c, d)), dtype=torch.float32)
    logp, grad = vag(q)
    metric, eps = make_metric(torch.ones(c, d)), torch.full((c,), 0.3)
    kernel = build_nuts_kernel(vag, max_depth=depth)
    got = kernel(q, logp, grad, eps, metric, rand=rand)
    want = nuts_transition(vag, metric, eps, q, logp, grad, depth, rand=rand)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in want[3]:
        torch.testing.assert_close(got[3][k], want[3][k], rtol=0, atol=0)
    capped = kernel(q, logp, grad, eps, metric, max_depth_dyn=2, rand=rand)
    assert int(capped[3]["depth"].max()) <= 2
    # a generator in place of injected draws: seeded runs repeat
    a = kernel(q, logp, grad, eps, metric, generator=torch.Generator().manual_seed(5))
    b = kernel(q, logp, grad, eps, metric, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


NEW_MODULES = ["apps", "apps.physics", "apps.physics.heat_2d", "apps.physics.level_set",
               "apps.poker", "apps.poker.cards", "apps.poker.action_model",
               "apps.poker.simulator", "apps.poker.opponent_model", "apps.poker.decision",
               "apps.poker.api", "apps.poker.table", "native", "benchmarks.apps"]


@pytest.mark.parametrize("mod", NEW_MODULES)
def test_new_module_source_names_no_jax(mod):
    path = os.path.join(ROOT, "exmc_tpu_torch", *mod.split("."))
    src = open(path + "/__init__.py" if os.path.isdir(path) else path + ".py").read()
    assert not re.search(r"^\s*(import|from) (jax|exmc_tpu)(\.|\s|$)", src, re.M)


def test_new_modules_import_no_jax():
    code = ("import sys; " + "; ".join(f"import exmc_tpu_torch.{m}" for m in NEW_MODULES)
            + "; bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'exmc_tpu' or m.startswith('exmc_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
