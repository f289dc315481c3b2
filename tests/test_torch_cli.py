"""The port's CLI (``python -m exmc_tpu_torch``) on the CPU: the
``check``, ``sample`` -> ``summary`` and syntax-error cases of
``tests/test_cli.py``, the fit layout shared with the JAX CLI (each
``summary`` reads the other's fits), the flags reaching the sampler, and
``optimize``, ``variational`` and ``sample --engine chees|meads`` run on
the CPU at a small size (the MAP report, the ADVI fit file, and ensemble
fits that both CLIs' ``summary`` read)."""

import json

import numpy as np
import pytest

from exmc_tpu.__main__ import _save_fit as jax_save_fit
from exmc_tpu.__main__ import main as jax_main
from exmc_tpu_torch.__main__ import _load_data, main
from exmc_tpu_torch.config import default_dtype

STAN = """
data { int N; array[N] real y; }
parameters { real mu; real<lower=0> sigma; }
model {
  mu ~ normal(0, 5);
  sigma ~ normal(0, 2);
  y ~ normal(mu, sigma);
}
"""

BAD_STAN = "parameters { real mu; }\nmodel { mu ~ nrmal(0, 1); }"


def _same_table(a, b):
    """Two summary outputs agree: the same rows and columns, and every
    number within 1e-3 relative (ESS comes from float32 FFTs in either
    package)."""
    la, lb = a.strip().splitlines(), b.strip().splitlines()
    assert len(la) == len(lb) and la[0] == lb[0]
    for ra, rb in zip(la[1:], lb[1:]):
        fa, fb = ra.split(), rb.split()
        assert len(fa) == len(fb)
        if not fa or fa[0] == "divergences:":
            assert fa == fb
            continue
        assert fa[0] == fb[0]
        np.testing.assert_allclose(np.asarray(fa[1:], float), np.asarray(fb[1:], float),
                                   rtol=1e-3, atol=2e-3)


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    model = d / "m.stan"
    model.write_text(STAN)
    data = d / "d.json"
    rng = np.random.default_rng(0)
    data.write_text(json.dumps(
        {"N": 12, "y": (2.0 + rng.normal(size=12)).round(3).tolist()}
    ))
    return str(model), str(data), d


def test_check_ok(model_files, capsys):
    model, data, _ = model_files
    assert main(["check", model, "--data", data, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "OK" in out
    assert "unconstrained dimension: 2" in out
    assert "mu" in out and "sigma" in out
    assert "observation terms: 1" in out
    assert jax_main(["check", model, "--data", data]) == 0
    assert capsys.readouterr().out.replace(model, "") == out.replace(model, "")


def test_check_syntax_error(model_files, capsys):
    _, _, d = model_files
    bad = d / "bad.stan"
    bad.write_text(BAD_STAN)
    assert main(["check", str(bad), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "FAIL" in err
    assert jax_main(["check", str(bad)]) == 1
    assert capsys.readouterr().err == err


@pytest.mark.parametrize("ext", ["npz", "json"])
def test_sample_summary_roundtrip(model_files, capsys, ext):
    model, data, d = model_files
    fit = str(d / f"fit.{ext}")
    rc = main(["sample", model, "--data", data, "--chains", "2", "--warmup", "40",
               "--samples", "30", "--seed", "1", "--output", fit, "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "divergences:" in out and "mu" in out and f"wrote {fit}" in out

    assert main(["summary", fit]) == 0
    ours = capsys.readouterr().out
    assert "mu" in ours and "sigma" in ours
    # the JAX CLI reads the port's fit and prints the same table
    assert jax_main(["summary", fit]) == 0
    _same_table(capsys.readouterr().out, ours)
    if ext == "npz":
        groups = np.load(fit)
        mu = groups["posterior/mu"]
        assert mu.shape == (2, 30)
        assert 0.0 < float(mu.mean()) < 4.0
        assert groups["sample_stats/diverging"].shape == (2, 30)
        assert groups["sample_stats/step_size"].shape == (2, 30)


@pytest.mark.parametrize("ext", ["npz", "json"])
def test_summary_reads_a_jax_fit(tmp_path, capsys, ext):
    """A fit in the JAX CLI's layout, written by its own writer: both
    summaries print the same table (to 1e-3)."""
    rng = np.random.default_rng(3)
    fit = str(tmp_path / f"jax_fit.{ext}")
    jax_save_fit(fit, {"posterior": {"mu": rng.normal(size=(3, 40)),
                                     "theta": rng.normal(size=(3, 40, 2))},
                       "sample_stats": {"diverging": np.zeros((3, 40), bool)}})
    assert main(["summary", fit]) == 0
    ours = capsys.readouterr().out
    assert "theta[1]" in ours and "divergences: 0" in ours
    assert jax_main(["summary", fit]) == 0
    _same_table(capsys.readouterr().out, ours)


def test_sample_flags_reach_the_sampler(model_files, monkeypatch):
    """--warmup, --target-accept, --max-depth, --no-ncp and --device reach
    ``stan.sample``; unset tuning flags are omitted."""
    model, data, _ = model_files
    captured = {}
    from exmc_tpu_torch.stan import frontend

    def fake_sample(code, d, **opts):
        captured.update(opts)
        return ({"mu": np.zeros((2, 4))}, {"diverging": np.zeros((2, 4))})

    monkeypatch.setattr(frontend, "sample", fake_sample)
    assert main(["sample", model, "--data", data, "--warmup", "77",
                 "--target-accept", "0.9", "--max-depth", "7", "--no-ncp",
                 "--device", "cpu"]) == 0
    assert captured == {"num_chains": 4, "num_samples": 1000, "seed": 0, "ncp": False,
                        "device": "cpu", "num_warmup": 77, "target_accept": 0.9,
                        "max_tree_depth": 7}
    captured.clear()
    assert main(["sample", model, "--data", data]) == 0
    for absent in ("num_warmup", "target_accept", "max_tree_depth"):
        assert absent not in captured, absent
    assert captured["device"] == "cuda"


@pytest.mark.parametrize("argv", [
    ["optimize", "{model}", "--data", "{data}"],
    ["variational", "{model}", "--data", "{data}"],
    ["sample", "{model}", "--data", "{data}", "--engine", "chees"],
    ["sample", "{model}", "--data", "{data}", "--engine", "meads"],
])
def test_commands_not_ported_yet(model_files, capsys, argv):
    """Each of these commands once waited for its module's port; each now
    runs on the CPU at a small size and prints what the JAX CLI prints:
    the MAP report (the same point as the JAX CLI's), the ADVI fit file,
    and ensemble fits that both summaries read."""
    model, data, d = model_files
    cmd = argv[0] if argv[0] != "sample" else argv[-1]
    fit = str(d / f"{cmd}.npz")
    small = {"optimize": ["--iters", "200"],
             "variational": ["--iters", "300", "--draws", "50", "--output", fit],
             "chees": ["--chains", "8", "--warmup", "30", "--samples", "20",
                       "--output", fit],
             "meads": ["--chains", "8", "--warmup", "30", "--samples", "20",
                       "--output", fit]}[cmd]
    argv = [a.format(model=model, data=data) for a in argv] + small
    assert main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    if cmd == "optimize":
        assert out.startswith("MAP (converged in ")
        assert jax_main(argv) == 0
        want = capsys.readouterr().out
        rows = lambda text: {ln.split()[0]: float(ln.split()[1])
                             for ln in text.strip().splitlines()[1:]}
        assert sorted(rows(out)) == sorted(rows(want)) == ["mu", "sigma"]
        for k, v in rows(want).items():
            assert rows(out)[k] == pytest.approx(v, rel=1e-4)
        return
    assert f"wrote {fit}" in out
    groups = np.load(fit)
    mu = groups["posterior/mu"]
    want_shape = (1, 50) if cmd == "variational" else (8, 20)
    assert mu.shape == want_shape and np.isfinite(mu).all()
    assert 0.0 < float(mu.mean()) < 4.0
    if cmd != "variational":
        assert groups["sample_stats/diverging"].shape == (8, 20)
    assert main(["summary", fit]) == 0
    ours = capsys.readouterr().out
    assert "mu" in ours and "sigma" in ours
    assert jax_main(["summary", fit]) == 0
    _same_table(capsys.readouterr().out, ours)


def test_engine_flags_reach_the_engines(model_files, monkeypatch, capsys):
    """--engine goes to ``stan.sample``; --target-accept reaches ChEES and
    is noted as ignored by MEADS, --max-depth by both."""
    model, data, _ = model_files
    captured = {}
    from exmc_tpu_torch.stan import frontend

    def fake_sample(code, d, **opts):
        captured.clear()
        captured.update(opts)
        return ({"mu": np.zeros((2, 4))}, {"diverging": np.zeros((2, 4))})

    monkeypatch.setattr(frontend, "sample", fake_sample)
    assert main(["sample", model, "--data", data, "--engine", "chees",
                 "--target-accept", "0.7", "--max-depth", "5"]) == 0
    assert captured["engine"] == "chees" and captured["target_accept"] == 0.7
    assert "max_tree_depth" not in captured and "num_warmup" not in captured
    assert "--max-depth is ignored" in capsys.readouterr().err
    assert main(["sample", model, "--data", data, "--engine", "meads",
                 "--target-accept", "0.7"]) == 0
    assert captured["engine"] == "meads" and "target_accept" not in captured
    assert "ignored by engine 'meads'" in capsys.readouterr().err


def test_load_data_uses_default_dtype(tmp_path):
    p = tmp_path / "d.json"
    p.write_text(json.dumps({"N": 3, "y": [1.0, 2.0, 3.0], "flag": True}))
    out = _load_data(str(p))
    assert out["N"] == 3 and isinstance(out["N"], int)
    assert out["flag"] == 1
    assert out["y"].dtype == np.dtype(str(default_dtype()).removeprefix("torch."))


def test_cli_entry_check_on_cpu():
    """The entry phase's CLI check (subprocesses, ``stan_logistic_d21``'s
    program and 500 x 21 data) at a small size on the CPU."""
    from exmc_tpu_torch.benchmarks import entry

    res = entry.check_cli("cpu", chains=2, warmup=20, samples=10, gates=False)
    assert res["ok"], res
    assert res["fit_shape"] == [2, 10, 21]
