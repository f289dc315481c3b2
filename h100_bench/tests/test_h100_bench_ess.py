"""The benchmark's copy of the bulk ESS."""

import math

import numpy as np
import torch

from h100_bench import ess


def test_ess_by_hand():
    """Chains [1, 2, 3, 4] and [4, 3, 2, 1]: both centre to +-[1.5, 0.5,
    -0.5, -1.5]; their biased autocovariances are 1.25, 0.3125, -0.375,
    -0.5625; W = 1.25 * 4 / 3 = 5/3, var_plus = 1.25 (equal means); so
    rho = 1, -1/12, -0.6333, -0.7833, pair sums 0.9167 and -1.4167, tau
    = -1 + 2 * 0.9167 = 0.8333, under the floor 1 / log10(4), which
    gives ESS = 8 log10(4)."""
    x = np.array([[1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0]])
    assert math.isclose(ess.ess(x), 8.0 * math.log10(4.0), rel_tol=1e-12)


def test_split_and_ranks_by_hand():
    x = np.array([[3.0, 1.0, 2.0, 2.0]])
    assert ess.split_chains(x).tolist() == [[3.0, 1.0], [2.0, 2.0]]
    # ranks 4, 1, 2.5, 2.5 (a tie at its average rank), Blom: (r - 0.375) / 4.25
    from scipy.special import ndtri

    want = ndtri((np.array([4.0, 1.0, 2.5, 2.5]) - 0.375) / 4.25)
    assert np.allclose(ess.rank_normalize(x)[0], want, rtol=0, atol=1e-15)


def test_bulk_ess_equals_the_ports():
    from exmc_tpu_torch.diagnostics import _ess_bulk

    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal((16, 200)), axis=1) * 0.1 + rng.standard_normal((16, 200))
    port = float(_ess_bulk(torch.as_tensor(x, dtype=torch.float64)))
    assert math.isclose(ess.ess_bulk(x), port, rel_tol=1e-9)


def test_scalar_columns_flatten_vectors():
    tr = {"b": np.zeros((2, 3, 4)), "a": np.ones((2, 3))}
    cols = ess.scalar_columns(tr)
    assert [c for c, _ in cols] == ["a", "b[0]", "b[1]", "b[2]", "b[3]"]
    assert all(v.shape == (2, 3) for _, v in cols)
