"""``exmc_tpu_torch.apps.poker`` against the JAX package's
``exmc_tpu.apps.poker`` on the same inputs: the numpy parts (cards,
simulator, tables, decisions, profile extraction) bit for bit; the
action model and the one-table and batched opponent models' log-density
and gradient at 8 seeded points, with T != P and with T == P (the
batched model's per-table hyperparameters must not broadcast against
the players' axis); then ``test_poker_table_session`` and a short
``profile`` run on the port, and the card tasks at small sizes."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import exmc_tpu.apps.poker as jpoker
from exmc_tpu.apps.poker import action_model as jaction
from exmc_tpu.apps.poker import cards as jcards
from exmc_tpu.apps.poker import opponent_model as jom
from exmc_tpu.compiler import compile_logp as jcompile
from exmc_tpu_torch.apps import poker
from exmc_tpu_torch.apps.poker import action_model, cards, opponent_model
from exmc_tpu_torch.benchmarks import apps
from exmc_tpu_torch.compiler import compile_logp
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)

REL_VALUE = 1e-5
REL_GRAD = 1e-4


def test_cards_match_jax():
    for s in ("Ah", "2c", "Td", "9s"):
        assert cards.parse(s) == jcards.parse(s)
        assert cards.card_name(cards.parse(s)) == s
    assert cards.deck() == jcards.deck()
    rng = np.random.default_rng(0)
    for _ in range(200):
        seven = [int(c) for c in rng.choice(52, 7, replace=False)]
        assert cards.evaluate_5(seven[:5]) == jcards.evaluate_5(seven[:5])
        assert cards.evaluate_7(seven) == jcards.evaluate_7(seven)
    hole, board = [cards.parse("Ah"), cards.parse("Kh")], [cards.parse("Td")]
    for seed in (0, 3):
        assert (cards.hand_strength(hole, board, samples=150, seed=seed)
                == jcards.hand_strength(hole, board, samples=150, seed=seed))


def test_simulate_tables_and_decisions_match_jax():
    players = poker.archetypes()[:4]
    assert poker.archetypes() == jpoker.archetypes()
    assert poker.simulate(players, hands=40, seed=5) == jpoker.simulate(players, hands=40,
                                                                        seed=5)
    assert poker.simulate() == jpoker.simulate()
    t, jt = poker.Table(seed=2).play(25), jpoker.Table(seed=2).play(25)
    assert t.observations == jt.observations
    mt = poker.MultiTable(num_tables=3, seed=4).play(hands=12)
    jmt = jpoker.MultiTable(num_tables=3, seed=4).play(hands=12)
    assert [x.observations for x in mt.tables] == [x.observations for x in jmt.tables]
    rng = np.random.default_rng(1)
    prof = {k: rng.uniform(0.1, 0.6, 30) for k in ("vpip", "pfr", "bluff")}
    prof["agg"] = rng.uniform(0.5, 3.0, 30)
    for hole, board, pot, call in ((["Ah", "Kh"], ["Td", "Jd", "2c"], 100, 30),
                                   (["7c", "2d"], [], 40, 20)):
        assert (poker.decide(hole, board, prof, pot=pot, to_call=call)
                == jpoker.decide(hole, board, prof, pot=pot, to_call=call))
    profiles = [{k: rng.uniform(0.1, 0.6, 20) for k in ("vpip", "pfr", "agg", "bluff")}
                for _ in players]
    assert poker.compare(players, profiles) == jpoker.compare(players, profiles)


def test_action_model_matches_jax():
    rng = np.random.default_rng(2)
    vpip, pfr, bluff = (rng.normal(0, 3, (4, 1)).astype(np.float32) for _ in range(3))
    agg = rng.uniform(0.0, 12.0, (4, 1)).astype(np.float32)
    hs = rng.random((4, 9)).astype(np.float32)
    acts = rng.integers(0, 3, (4, 9)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (vpip, pfr, agg, bluff, hs)]
    j = [jnp.asarray(a) for a in (vpip, pfr, agg, bluff, hs)]
    np.testing.assert_array_equal(action_model.action_logits(*t).numpy(),
                                  np.asarray(jaction.action_logits(*j)))
    lp, jlp = action_model.log_action_probs(*t), jaction.log_action_probs(*j)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        action_model.gather_log_probs(lp, torch.as_tensor(acts)).numpy(),
        np.asarray(jaction.gather_log_probs(jnp.asarray(lp.numpy()), jnp.asarray(acts))))
    for args in ((0.3, 0.2, 1.5, 0.1, 0.7), (0.9, 0.1, 0.5, 0.4, 0.05)):
        assert action_model.action_probs(*args) == jaction.action_probs(*args)
        r, jr = np.random.default_rng(7), np.random.default_rng(7)
        assert ([action_model.sample_action(r, *args) for _ in range(50)]
                == [jaction.sample_action(jr, *args) for _ in range(50)])


def _compare_models(jir, tir):
    jm, tm = jcompile(jir, ncp=False), compile_logp(tir, ncp=False, device="cpu")
    assert tm.size == jm.size
    assert [e.id for e in tm.pm.entries] == [e.id for e in jm.pm.entries]
    x = np.random.default_rng(8).normal(size=(8, tm.size)).astype(np.float32)
    lp, g = tm.value_and_grad(torch.as_tensor(x))
    jv, jg = (np.asarray(a) for a in jax.jit(jax.vmap(jm.value_and_grad))(jnp.asarray(x)))
    for i in range(8):
        assert abs(float(lp[i]) - jv[i]) <= REL_VALUE * abs(jv[i])
        assert np.abs(g[i].numpy() - jg[i]).max() <= REL_GRAD * np.abs(jg[i]).max()


def test_build_matches_jax():
    obs, _ = jpoker.simulate(jpoker.archetypes()[:4], hands=25, seed=3)
    obs[2] = {k: v[:17] for k, v in obs[2].items()}  # a shorter history (mask)
    _compare_models(jom.build(obs), opponent_model.build(obs))


@pytest.mark.parametrize("t,p", [(4, 3), (3, 3), (2, 5)])
def test_build_batched_matches_jax(t, p):
    tables = [jpoker.simulate(jpoker.archetypes()[:p], hands=12 + ti, seed=ti)[0]
              for ti in range(t)]
    tables[-1] = tables[-1][:p - 1]  # a table with a player fewer
    _compare_models(jom.build_batched(tables), opponent_model.build_batched(tables))


def _synthetic_trace(rng, batched):
    lead = (2, 6, 3) if batched else (2, 6)
    tr = {}
    for prm in opponent_model.PARAMS:
        tr[f"mu_{prm}"] = rng.normal(size=lead)
        tr[f"sigma_{prm}"] = rng.uniform(0.1, 2.0, lead)
        tr[f"{prm}_raw"] = rng.normal(0, 4, lead + (4,))
    return tr


def _assert_profiles_equal(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert pa.keys() == pb.keys()
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])


def test_extract_profiles_match_jax():
    rng = np.random.default_rng(9)
    tr = _synthetic_trace(rng, False)
    _assert_profiles_equal(opponent_model.extract_profiles(tr, 4), jom.extract_profiles(tr, 4))
    tr = _synthetic_trace(rng, True)
    got = opponent_model.extract_profiles_batched(tr, [4, 2, 3])
    want = jom.extract_profiles_batched(tr, [4, 2, 3])
    for a, b in zip(got, want):
        _assert_profiles_equal(a, b)


def test_poker_table_session():
    t = poker.Table(poker.archetypes()[:2], seed=0).play(30)
    assert t.hand_counts() == [30, 30]
    t.play(10)
    assert t.hand_counts() == [40, 40]


def test_profile_runs_on_the_cpu():
    obs, truth = poker.simulate(poker.archetypes()[:2], hands=15, seed=0)
    profiles, stats = poker.profile(obs, num_samples=8, num_warmup=8, seed=1, device="cpu",
                                    max_tree_depth=4)
    assert len(profiles) == 2 and all(p["vpip"].shape == (8,) for p in profiles)
    assert all(np.isfinite(v).all() for p in profiles for v in p.values())
    assert stats["depth"].shape == (1, 8)
    assert [r["player"] for r in poker.compare(truth, profiles)] == ["tag", "lag"]


def test_card_task_helpers_small():
    session = poker.MultiTable(num_tables=4, seed=1).play(hands=10)
    res = apps.batched_vs_tables([t.observations for t in session.tables],
                                 torch.device("cpu"))
    assert (res["T"], res["P"]) == (4, 3) and res["rel_err"] <= REL_VALUE
    obs, _ = jpoker.simulate(jpoker.archetypes()[:3], hands=80, seed=0)
    assert apps.obs_digest(obs) == apps.EX06_OBS_SHA256
    err = apps.compile_check(opponent_model.build(obs), torch.device("cpu"))
    assert err == {"value_rel_err": 0.0, "grad_rel_err": 0.0}


def test_chip_smoke_schedules_every_apps_task():
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    tasks = chip_smoke.pool_tasks()
    assert {t for k, t in tasks if k == "apps"} == set(apps.TASKS)
    assert {t for k, t in chip_smoke.POOL_COST_S if k == "apps"} == set(apps.TASKS)
    assert chip_smoke.N_APPS_ROWS == len(apps.TASKS) == 4
    assert apps.NATIVE_TASK not in apps.TASKS  # the build phase runs it
    with pytest.raises(SystemExit):
        apps.main(["--task", "apps:nope"])
