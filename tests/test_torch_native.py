"""The port's native tree binding (``exmc_tpu_torch.native``) against the
JAX package's (``exmc_tpu.native``): both load ``native/exmc_tree/tree.cpp``
built with g++, each into its own directory, and must return the same
tree field for field, with the internal generator (seeded) and with
forced directions, from numpy arrays or CPU tensors."""

import os

import numpy as np
import pytest
import torch

from exmc_tpu import native as jnative
from exmc_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leapfrog_chain(q0, p0, eps, n, prec):
    """An n-step float64 leapfrog chain on N(0, diag(1/prec)); a large
    step diverges to inf/NaN, which the tree must treat as divergent."""
    qs, ps, lps = [], [], []
    q, p = q0.copy(), p0.copy()
    g = -prec * q
    for _ in range(n):
        p_half = p + 0.5 * eps * g
        q = q + eps * p_half
        g = -prec * q
        p = p_half + 0.5 * eps * g
        qs.append(q.copy())
        ps.append(p.copy())
        with np.errstate(over="ignore", invalid="ignore"):
            lps.append(-0.5 * float(q @ (prec * q)))
    return np.array(qs), np.array(ps), np.array(lps)


def _trees(n_trees=220, max_depth=7, seed=0):
    rng = np.random.default_rng(seed)
    for t in range(n_trees):
        d = int(rng.integers(1, 5))
        prec = rng.uniform(0.3, 30.0 if t % 7 == 0 else 3.0, d)
        q0, p0 = rng.normal(size=d), rng.normal(size=d)
        eps = float(rng.uniform(0.05, 1.2))
        n = 2 ** max_depth
        yield dict(q0=q0, p0=p0, logp0=-0.5 * float(q0 @ (prec * q0)),
                   fwd=_leapfrog_chain(q0, p0, eps, n, prec),
                   bwd=_leapfrog_chain(q0, p0, -eps, n, prec), inv_mass=np.ones(d),
                   max_depth=max_depth, seed=t,
                   dirs=[1 if b else -1 for b in rng.random(max_depth) < 0.5])


def test_builds_into_the_ports_build_directory():
    if not native.available():
        pytest.skip("native toolchain (g++) unavailable")
    path = native.library_path()
    assert path.exists()
    assert path.parent == native.BUILD_DIR
    assert os.path.relpath(path, ROOT).split(os.sep)[:2] == ["build", "exmc_tpu_torch"]
    assert native.SRC == jnative._SRC


@pytest.mark.parametrize("forced", [False, True])
def test_equals_the_jax_binding_field_for_field(forced):
    if not (native.available() and jnative.available()):
        pytest.skip("native toolchain (g++) unavailable")
    depths, n = set(), 0
    for tree in _trees():
        kw = dict(tree)
        if not forced:
            kw.pop("dirs")
        got, want = native.build_full_tree(**kw), jnative.build_full_tree(**kw)
        assert got == want, (tree["seed"], got, want)
        depths.add(got["depth"])
        n += 1
    assert n >= 200 and len(depths) >= 3


def test_takes_cpu_tensors():
    if not native.available():
        pytest.skip("native toolchain (g++) unavailable")
    tree = next(_trees(1))
    want = native.build_full_tree(**tree)
    as_t = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in tree.items() if k not in ("fwd", "bwd")}
    for k in ("fwd", "bwd"):
        as_t[k] = tuple(torch.as_tensor(a) for a in tree[k])
    as_t["dirs"] = torch.as_tensor(tree["dirs"])
    assert native.build_full_tree(**as_t) == want


@pytest.mark.parametrize("dirs", [[1, -1, 1], [1, 0, 1, 1, -1, 1, 1], [2] * 7])
def test_bad_dirs_raise_as_in_jax(dirs):
    if not (native.available() and jnative.available()):
        pytest.skip("native toolchain (g++) unavailable")
    tree = dict(next(_trees(1)), dirs=dirs)
    with pytest.raises(ValueError, match="dirs must have >= max_depth"):
        native.build_full_tree(**tree)
    with pytest.raises(ValueError, match="dirs must have >= max_depth"):
        jnative.build_full_tree(**tree)
