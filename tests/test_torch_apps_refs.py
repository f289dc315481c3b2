"""The JAX package's reference values of the ``apps`` card tasks, which
``exmc_tpu_torch.benchmarks.apps`` stores as constants (the port never
imports JAX to get them).

Regenerate them on the CPU with

    JAX_PLATFORMS=cpu python tests/test_torch_apps_refs.py

which runs the JAX package's apps at the tasks' recipes (example 06 over
NUTS seeds 42-45, example 05's inverse model at the ``PHYSICS`` recipe
over seeds 0-3; a few minutes) and prints the constants to paste into
the port. The tests below hold the stored digest and equity to the JAX
package's and check the stored ranges' form."""

import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script from any directory
    sys.path.insert(0, str(ROOT))

import exmc_tpu.apps.poker as jpoker  # noqa: E402
from exmc_tpu.apps import physics as jphysics  # noqa: E402
from exmc_tpu_torch.benchmarks import apps  # noqa: E402

VPIP_SEEDS = (42, 43, 44, 45)
PHYSICS_SEEDS = (0, 1, 2, 3)


def jax_example06_obs():
    ex = apps.EX06
    return jpoker.simulate(jpoker.archetypes()[:ex["players"]], hands=ex["hands"],
                           seed=ex["sim_seed"])


def jax_equity():
    ex = apps.EX06
    prof = {k: np.full(4, 0.5) for k in ("vpip", "pfr", "agg", "bluff")}
    return jpoker.decide(ex["hole"], ex["board"], prof, pot=ex["pot"],
                         to_call=ex["to_call"])["equity"]


def jax_vpip(seed):
    ex = apps.EX06
    obs, truth = jax_example06_obs()
    profiles, _ = jpoker.profile(obs, num_samples=ex["draws"], num_warmup=ex["warmup"],
                                 seed=seed)
    return {t["label"]: float(np.mean(p["vpip"])) for t, p in zip(truth, profiles)}


def jax_physics(seed):
    import jax.numpy as jnp
    from exmc_tpu import sample

    cfg = apps.PHYSICS
    phi_true, noisy = apps.example05_data(cfg["ny"], cfg["nx"], cfg["iterations"])

    def forward(phi):
        kappa = jphysics.material_field(phi, 2.0, 0.5)
        t = jphysics.heat2d_solve(kappa, iterations=cfg["iterations"])
        return jphysics.read_sensors(t, "bottom_row")

    ir = jphysics.build_inverse_model(forward, jnp.asarray(noisy), ny=cfg["ny"],
                                      nx=cfg["nx"], noise_sigma=cfg["noise_sigma"],
                                      lam=cfg["lam"])
    trace, stats = sample(ir, num_chains=cfg["chains"], num_warmup=cfg["warmup"],
                          num_samples=cfg["draws"], seed=seed,
                          max_tree_depth=cfg["max_tree_depth"])
    return apps.physics_summary({k: np.asarray(v) for k, v in trace.items()},
                                {k: np.asarray(v) for k, v in stats.items()},
                                phi_true, cfg["max_tree_depth"])


def _range(values):
    return [min(values), max(values)]


def main():
    obs, _ = jax_example06_obs()
    vpips = [jax_vpip(s) for s in VPIP_SEEDS]
    phys = [jax_physics(s) for s in PHYSICS_SEEDS]
    print("# per seed:", json.dumps({"vpip": vpips, "physics": phys}))
    print(f"EX06_OBS_SHA256 = {apps.obs_digest(obs)!r}")
    print(f"EX06_EQUITY_JAX = {jax_equity()!r}")
    print("EX06_VPIP_JAX = " + repr({k: tuple(_range([v[k] for v in vpips]))
                                     for k in vpips[0]}))
    print("PHYSICS_JAX = " + repr({k: tuple(_range([p[k] for p in phys]))
                                   for k in ("max_depth_share", "step_size")}))


def test_stored_digest_and_equity_are_the_jax_packages():
    obs, _ = jax_example06_obs()
    assert apps.obs_digest(obs) == apps.EX06_OBS_SHA256
    assert jax_equity() == apps.EX06_EQUITY_JAX


def test_stored_ranges_are_ordered():
    assert set(apps.EX06_VPIP_JAX) == {"tag", "lag", "nit"}
    for lo, hi in list(apps.EX06_VPIP_JAX.values()) + list(apps.PHYSICS_JAX.values()):
        assert 0 < lo <= hi
    assert apps.PHYSICS_JAX["max_depth_share"][1] <= 1.0


if __name__ == "__main__":
    main()
