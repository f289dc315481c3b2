"""ASIS interweaving and NUTS-within-Gibbs scale updates
(``exmc_tpu/nuts/interweave.py``).

After each NUTS transition, every eligible scale sigma gets one Gibbs
update in the centered (sufficient) parameterization: with the path
held fixed, the proposal v' = sigma'^2 = SSE / chi2_n (an independence
draw from the dominant inverse-chi^2 factor) is MH-corrected by the
prior,

    log alpha = [log p_v(v') - log p_v(v)] + [log v' - log v],
    p_v(v) = p_sigma(sqrt v) / (2 sqrt v),

and non-centered latents are rescaled z' = z sigma / sigma' so the
reconstructed path does not move. Centered hierarchical-Normal groups
also get the ancillary leg (Yu & Meng 2011): with z = (theta - mu) /
sigma held fixed, sigma | z, mu, y is a Gaussian regression, drawn
truncated to sigma > 0 by inverse CDF and MH-corrected by the prior
ratio alone; without observations that conditional is the prior itself,
an always-accepted prior draw. ``build_conditional_metric`` gives the
analytic conditional inverse mass of the latents for ``gibbs_scales``.

Eligibility (``eligible_groups``) walks the IR as the JAX package does
and returns the same groups. The step runs all chains at once: a
group's coordinate is the column ``q[:, off]``, a latent the slice
``q[:, off:off + n]``, and every choice that differs per chain is a
``torch.where``, so the step adds no host sync.

Randomness comes from a ``torch.Generator``, or is injected through
``rand`` (for lockstep tests against the JAX step): one dict per group
with (C,) tensors ``chi2`` (the chi^2_n draw), ``u_acc`` (uniform),
and for groups with an ancillary leg ``u_anc`` (the uniform of the
inverse-CDF draw; in prior mode the prior draw of sigma itself) and
``u_acc2`` (uniform).

Observations on the runtime data channel (``OBS_DATA_KEY``, whole or
keyed) are read from the run's data at each step, as the compiled
log-density reads them; the model's own data when the run passes none.
"""

import warnings

import numpy as np
import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.compiler import OBS_DATA_KEY, _align_dist, _base_data, _const
from exmc_tpu_torch.dists.base import Distribution, get as get_dist
from exmc_tpu_torch.point_map import _infer_shape
from exmc_tpu_torch.transforms import get as get_transform


def _plain_obs_meta(meta):
    """True when obs metadata is the plain form the Gaussian conditionals
    assume: unit weight, default likelihood, no mask, no censoring, and
    reduce None/"sum"."""
    w = meta.get("weight")
    if not (w is None or (np.isscalar(w) and float(w) == 1.0)):
        return False
    if meta.get("likelihood") not in (None, True):
        return False
    if meta.get("mask") is not None or meta.get("censored") is not None:
        return False
    return meta.get("reduce") in (None, "sum")


def _obs_index(ir):
    """{rv_id: [obs nodes]}."""
    out = {}
    for n in ir.nodes.values():
        if n.op[0] == "obs":
            out.setdefault(n.op[1], []).append(n)
    return out


def _obs_value_spec(ir, value):
    """("const", array) for inline values, ("data", key, template) for
    the runtime data channel, None when unusable."""
    if isinstance(value, str):
        if value != OBS_DATA_KEY or ir.data is None:
            return None
        base = ir.data
        if isinstance(base, dict):
            base = base.get("__base")
        if base is None:
            return None
        return ("data", None, np.asarray(base, np.float64))
    if isinstance(value, tuple):
        if (len(value) == 2 and value[0] == OBS_DATA_KEY
                and isinstance(ir.data, dict) and value[1] in ir.data):
            return ("data", value[1], np.asarray(ir.data[value[1]],
                                                 np.float64))
        return None
    if isinstance(value, dict):
        return None
    return ("const", np.asarray(value, np.float64))


def _obs_term_shape(node, value, extra=()):
    """Broadcast shape of the obs likelihood terms: the observed rv's
    declared shape with the obs value (a scalar value on a vector rv is
    one term per element)."""
    rv_shape = tuple(_infer_shape(node) or ())
    return np.broadcast_shapes(np.asarray(value).shape, rv_shape, *extra)


def _coord_mu_spec(ir, entries, ncp, mu):
    """("coord", offset, length) for a mean that is an identity-transform
    free RV, ("const", value) for a scalar constant, else None."""
    if isinstance(mu, str):
        e_mu = entries.get(mu)
        mu_node = ir.nodes.get(mu)
        if (e_mu is None or e_mu.transform not in (None, "identity")
                or mu in ncp or mu_node is None or mu_node.op[0] != "rv"):
            return None
        return ("coord", e_mu.offset, e_mu.length)
    if np.isscalar(mu) or np.asarray(mu).ndim == 0:
        return ("const", float(mu))
    return None


def _anc_obs_info(ir, entries, ncp, obs_by_rv, latent_id, latent_len):
    """Ancillary-leg eligibility of one centered-Normal latent theta:
    every reference to theta must be an observed Normal y ~ N(theta, s)
    with plain metadata, y referenced nowhere else, s a constant or a
    scalar free RV. Returns [(y_spec, s_spec)] with s_spec ("const",
    array) or ("coord", offset, transform); None when theta has other
    uses."""
    out = []
    for nid, n in ir.nodes.items():
        if nid == latent_id or latent_id not in n.deps:
            continue
        if n.op[0] == "obs":
            return None
        if n.op[0] != "rv" or get_dist(n.op[1]).name != "normal":
            return None
        params = n.op[2]
        if params.get("mu") != latent_id:
            return None
        sig = params.get("sigma")
        if isinstance(sig, str):
            e_s = entries.get(sig)
            s_node = ir.nodes.get(sig)
            if (e_s is None or e_s.length != 1 or sig in ncp
                    or s_node is None or s_node.op[0] != "rv"):
                return None
            s_spec = ("coord", e_s.offset, get_transform(e_s.transform))
            s_shape = ()
        else:
            s_arr = np.asarray(sig, np.float64)
            s_spec = ("const", s_arr)
            s_shape = s_arr.shape
        obs = obs_by_rv.get(nid, [])
        if len(obs) != 1:
            return None
        if not _plain_obs_meta(obs[0].op[3]):
            return None
        y_spec = _obs_value_spec(ir, obs[0].op[2])
        if y_spec is None:
            return None
        if any(nid in m.deps for mid, m in ir.nodes.items()
               if mid != obs[0].id and m.op[0] != "obs"):
            return None
        try:
            y_tmpl = y_spec[-1]
            bshape = _obs_term_shape(n, y_tmpl, (s_shape, (latent_len,)))
        except ValueError:
            return None
        if latent_len > 1 and bshape[-1] != latent_len:
            return None
        if s_spec[0] == "const":
            s_spec = ("const", np.broadcast_to(s_spec[1], bshape).copy())
        if y_spec[0] == "const":
            y_spec = ("const", np.broadcast_to(y_tmpl, bshape).copy())
        else:
            y_spec = ("data", y_spec[1], bshape)
        out.append((y_spec, s_spec))
    return out


class _ExpChainTransform:
    """sigma = exp(c * y) as the constraint transform of the scalar free
    coordinate y (Neal's funnel x ~ N(0, exp(y/2)): c = 1/2)."""

    def __init__(self, c):
        self.c = c

    def forward(self, u):
        return torch.exp(self.c * u)

    def inverse(self, s):
        return torch.log(s) / self.c


class _ExpChainScaleDist(Distribution):
    """Pushforward density of sigma = exp(c y), y ~ base(params):
    p_s(s) = p_y(log(s) / c) / (c s)."""

    def __init__(self, base, c):
        self.base, self.c = base, c

    def logpdf(self, s, params):
        yv = torch.log(s) / self.c
        return self.base.logpdf(yv, params) - np.log(self.c) - torch.log(s)

    def sample(self, params, shape, generator):
        return torch.exp(self.c * self.base.sample(params, shape, generator))


def _resolve_exp_chain(ir, entries, ncp, sig):
    """``sig`` names a det node exp(c * y) of a scalar free RV y (identity
    transform, not NCP'd, c > 0): (y_id, c, chain) with chain (exp_id,)
    or (exp_id, mul_id); else None."""
    node = ir.nodes.get(sig)
    if node is None or node.op[0] != "det" or node.op[1] != "exp":
        return None
    args = node.op[2]
    if len(args) != 1 or not isinstance(args[0], str):
        return None
    inner = args[0]
    chain = (sig,)
    c = 1.0
    nd = ir.nodes.get(inner)
    if nd is not None and nd.op[0] == "det" and nd.op[1] == "mul":
        margs = nd.op[2]
        if len(margs) != 2:
            return None
        refs = [a for a in margs if isinstance(a, str)]
        consts = [a for a in margs if not isinstance(a, str)]
        if len(refs) != 1 or len(consts) != 1 or np.ndim(consts[0]) != 0:
            return None
        c = float(consts[0])
        chain = (sig, inner)
        inner = refs[0]
        nd = ir.nodes.get(inner)
    if c <= 0:
        return None
    e = entries.get(inner)
    if (e is None or e.length != 1 or inner in ncp or nd is None
            or nd.op[0] != "rv" or e.transform not in (None, "identity")):
        return None
    return inner, c, chain


def _referencing_ids(ir, ncp, target):
    """Node ids referencing ``target``: Node.deps plus NCP
    reconstruction refs."""
    out = {nid for nid, n in ir.nodes.items()
           if nid != target and target in n.deps}
    for nid, info in ncp.items():
        if info.get("mu") == target or info.get("sigma") == target:
            out.add(nid)
    return out


def eligible_groups(model):
    """Interweavable scales, as the JAX package finds them: a list of
    groups {sigma_id, offset, transform, dist, params, zs, n, anc,
    anc_mode}. ``zs`` holds (offset, length, kind, spec) per latent with
    kind "ncp", "centered" (GRW path), "centered_normal" or "obs_noise".
    """
    ir, pm, ncp = model.ir, model.pm, model.ncp_info
    entries = {e.id: e for e in pm.entries}

    by_sigma = {}
    for nid, info in ncp.items():
        sig = info.get("sigma")
        if info.get("kind") == "affine":
            continue
        if isinstance(sig, str):
            by_sigma.setdefault(sig, []).append((nid, "ncp", None))
    for nid, node in ir.nodes.items():
        if node.op[0] != "rv" or nid not in entries or nid in ncp:
            continue
        name = get_dist(node.op[1]).name
        if name == "gaussian_random_walk":
            sig = node.op[2].get("sigma")
            if isinstance(sig, str):
                by_sigma.setdefault(sig, []).append((nid, "centered", None))
        elif name == "normal" and len(node.op) == 3:
            sig = node.op[2].get("sigma")
            if not isinstance(sig, str):
                continue
            mu_spec = _coord_mu_spec(ir, entries, ncp, node.op[2].get("mu"))
            if mu_spec is None:
                continue
            by_sigma.setdefault(sig, []).append(
                (nid, "centered_normal", mu_spec))

    # observation-noise scales: referenced only as the sigma of observed
    # Normals whose mean is a constant or an identity coordinate
    obs_by_rv = _obs_index(ir)
    for nid, node in ir.nodes.items():
        if (node.op[0] != "rv" or nid in entries or nid in ncp
                or nid not in obs_by_rv):
            continue
        if get_dist(node.op[1]).name != "normal":
            continue
        sig = node.op[2].get("sigma")
        if not isinstance(sig, str):
            continue
        obs = obs_by_rv[nid]
        if len(obs) != 1 or not _plain_obs_meta(obs[0].op[3]):
            continue
        y_spec = _obs_value_spec(ir, obs[0].op[2])
        if y_spec is None:
            continue
        mu_spec = _coord_mu_spec(ir, entries, ncp, node.op[2].get("mu"))
        if mu_spec is None:
            continue
        try:
            mu_len = (mu_spec[2],) if mu_spec[0] == "coord" else ()
            bshape = _obs_term_shape(node, y_spec[-1], (mu_len,))
        except ValueError:
            continue
        if y_spec[0] == "const":
            y_spec = ("const", np.broadcast_to(y_spec[1], bshape).copy())
        else:
            y_spec = ("data", y_spec[1], bshape)
        by_sigma.setdefault(sig, []).append(
            (nid, "obs_noise", (mu_spec, y_spec)))

    groups = []
    for sig, latents in by_sigma.items():
        kinds = {k for _, k, _ in latents}
        if "obs_noise" in kinds and kinds != {"obs_noise"}:
            continue
        e_sig = entries.get(sig)
        chain = None
        if e_sig is None:
            resolved = _resolve_exp_chain(ir, entries, ncp, sig)
            if resolved is None:
                continue
            scale_rv, c_exp, chain = resolved
            e_sig = entries[scale_rv]
            node = ir.nodes[scale_rv]
            if _referencing_ids(ir, ncp, scale_rv) != {chain[-1]}:
                continue
            if (len(chain) == 2
                    and _referencing_ids(ir, ncp, chain[1]) != {chain[0]}):
                continue
        else:
            if e_sig.length != 1:
                continue
            node = ir.nodes.get(sig)
            if node is None or node.op[0] != "rv" or sig in ncp:
                continue
        prior_params = node.op[2]
        if any(isinstance(v, str) for v in prior_params.values()):
            continue
        if any(kind == "ncp" and ncp[nid].get("mu") == sig
               for nid, kind, _ in latents):
            continue
        if any(kind == "centered_normal"
               and ir.nodes[nid].op[2].get("mu") == sig
               for nid, kind, _ in latents):
            continue
        grouped = {nid for nid, _, _ in latents}
        if _referencing_ids(ir, ncp, sig) - grouped:
            continue
        zs = []
        ok = True
        for nid, kind, mu_spec in latents:
            if kind == "obs_noise":
                mu_s, y_spec = mu_spec
                n_terms = (y_spec[1].size if y_spec[0] == "const"
                           else int(np.prod(y_spec[2], dtype=int)))
                zs.append((0, n_terms, kind, (mu_s, y_spec)))
                continue
            e = entries.get(nid)
            if e is None:
                ok = False
                break
            if (mu_spec is not None and mu_spec[0] == "coord"
                    and mu_spec[2] not in (1, e.length)):
                ok = False
                break
            zs.append((e.offset, e.length, kind, mu_spec))
        if not ok or not zs:
            continue
        anc = None
        if all(kind == "centered_normal" for _, kind, _ in latents):
            anc = []
            for nid, _, mu_spec in latents:
                e = entries[nid]
                info = _anc_obs_info(ir, entries, ncp, obs_by_rv,
                                     nid, e.length)
                if info is None:
                    anc = None
                    break
                anc.append((e.offset, e.length, mu_spec, tuple(info)))
        anc_mode = None
        if anc is not None:
            anc_mode = ("regression"
                        if any(info for *_, info in anc) else "prior")
        groups.append({
            "sigma_id": sig,
            "offset": e_sig.offset,
            "transform": (_ExpChainTransform(c_exp) if chain
                          else get_transform(e_sig.transform)),
            "dist": (_ExpChainScaleDist(get_dist(node.op[1]), c_exp)
                     if chain else get_dist(node.op[1])),
            "params": {k: np.asarray(v, np.float64)
                       if not np.isscalar(v) else v
                       for k, v in prior_params.items()},
            "zs": tuple(zs),
            "n": int(sum(ln for _, ln, _, _ in zs)),
            "anc": tuple(anc) if anc is not None else None,
            "anc_mode": anc_mode,
        })
    return groups


def _event(x, nd):
    """A (C, L) slice of q as (C, 1, ..., 1, L) with ``nd`` event axes,
    so it broadcasts right-aligned against an observation array, as the
    (L,) slice of one point does in JAX."""
    return x.reshape(x.shape[:1] + (1,) * (nd - 1) + x.shape[1:])


def _mean_value(q, mu_spec):
    """A latent's mean: 0.0, a constant, or the (C, L) slice of q."""
    if mu_spec is None:
        return 0.0
    if mu_spec[0] == "const":
        return mu_spec[1]
    return q[:, mu_spec[1]:mu_spec[1] + mu_spec[2]]


def _prior_logpdf(g, s):
    """The scale's prior log-density per chain, s (C,) -> (C,)."""
    s, params = _align_dist(g["dist"], s, g["params_t"])
    return xm.event_sum(g["dist"].logpdf(s, params))


def _in_domain(tf, sigma_prop):
    """u' = tf.inverse(sigma') and whether it is a valid proposal: finite,
    and mapping back onto sigma' (the transform may not cover all of R+,
    and its inverse writes NaN outside its image)."""
    u_prop = tf.inverse(sigma_prop)
    rt = tf.forward(u_prop)
    ok = (torch.isfinite(u_prop) & torch.isfinite(rt)
          & (torch.abs(rt - sigma_prop) <= 1e-3 * torch.abs(sigma_prop) + 1e-12))
    return u_prop, ok & torch.isfinite(sigma_prop) & (sigma_prop > 0)


def _device_spec(spec, device):
    """An obs y/s spec with its constant array as a (1, *bshape) device
    tensor, made once at build time."""
    if spec[0] == "const":
        return ("const", _const(np.asarray(spec[1]).reshape(
            np.shape(spec[1]) or (1,)), device))
    return spec


def _y_runtime(spec, data):
    """An obs y spec as a (1, *bshape) tensor: the constant, or the
    run's data (a ``DeviceData``) broadcast to the spec's shape."""
    if spec[0] == "const":
        return spec[1]
    _, key, bshape = spec
    raw = _base_data(data.value) if key is None else data.value[key]
    return torch.broadcast_to(raw, (1,) + (tuple(bshape) or (1,)))


def build_interweave(model):
    """``step(q, generator=None, rand=None, data=None) -> (q',
    accept_frac)`` applying one ASIS scale update per eligible group to
    every chain of the (C, d) batch ``q`` (``accept_frac`` is (C,)), or
    None when nothing is eligible. ``data`` (a ``DeviceData``; None: the
    model's own) supplies observations read from the data channel."""
    groups = eligible_groups(model)
    if not groups:
        return None
    dev = model.device
    own_data = model.device_data()
    for g in groups:
        g["params_t"] = {k: _const(v, dev) for k, v in g["params"].items()}
        g["zs_t"] = [(zoff, zlen, kind, spec if kind != "obs_noise" else
                      (spec[0], _device_spec(spec[1], dev)))
                     for zoff, zlen, kind, spec in g["zs"]]
        g["anc_t"] = None if g["anc"] is None else [
            (zoff, zlen, mu_spec,
             [(_device_spec(y, dev), _device_spec(s, dev) if s[0] == "const"
               else s) for y, s in obs_info])
            for zoff, zlen, mu_spec, obs_info in g["anc"]]

    def step(q, generator=None, rand=None, data=None):
        c = q.shape[0]
        q = q.clone()
        data = own_data if data is None else data

        def draw(i, name, make):
            return make() if rand is None else rand[i][name]

        def uniform():
            return torch.rand(c, generator=generator, device=q.device,
                              dtype=q.dtype)

        accepts = []
        for i, g in enumerate(groups):
            off, tf, n = g["offset"], g["transform"], g["n"]
            u = q[:, off].clone()
            sigma = tf.forward(u)
            v = sigma * sigma
            sse = torch.zeros_like(u)
            for zoff, zlen, kind, spec in g["zs_t"]:
                if kind == "obs_noise":
                    # SSE of the observed residuals y - mean(q); zoff/zlen
                    # describe the data, not a slice of q
                    mu_s, y_spec = spec
                    y = _y_runtime(y_spec, data)
                    mu_v = _mean_value(q, mu_s)
                    if torch.is_tensor(mu_v):
                        mu_v = _event(mu_v, y.ndim - 1)
                    resid = y - mu_v
                    sse = sse + xm.event_sum(resid * resid)
                    continue
                zseg = q[:, zoff:zoff + zlen]
                if kind == "ncp":
                    # sigma^2 |z|^2 (|w| = |z| under the spectral rotation)
                    sse = sse + v * torch.sum(zseg * zseg, dim=-1)
                elif kind == "centered":
                    inc = torch.cat([zseg[:, :1], torch.diff(zseg, dim=-1)],
                                    dim=-1)
                    sse = sse + torch.sum(inc * inc, dim=-1)
                else:
                    resid = zseg - _mean_value(q, spec)
                    sse = sse + torch.sum(resid * resid, dim=-1)
            sse = torch.clamp_min(sse, 1e-20)
            chi2 = draw(i, "chi2", lambda: 2.0 * torch._standard_gamma(
                torch.full_like(u, 0.5 * n), generator=generator))
            v_new = sse / torch.clamp_min(chi2, 1e-20)
            sigma_new = torch.sqrt(v_new)

            def lpv(s_val):
                return _prior_logpdf(g, s_val) - torch.log(2.0 * s_val)

            log_alpha = (lpv(sigma_new) - lpv(sigma)
                         + torch.log(v_new) - torch.log(v))
            accept = torch.log(draw(i, "u_acc", uniform)) < log_alpha
            u_prop, ok = _in_domain(tf, sigma_new)
            accept = accept & ok
            scale = torch.where(accept, sigma / sigma_new,
                                torch.ones_like(sigma))
            for zoff, zlen, kind, _ in g["zs_t"]:
                if kind == "ncp":
                    q[:, zoff:zoff + zlen] = q[:, zoff:zoff + zlen] * scale[:, None]
            q[:, off] = torch.where(accept, u_prop, u)
            accepts.append(accept.to(q.dtype))

            if g["anc_t"] is None:
                continue
            # ancillary leg: z = (theta - mu) / sigma held fixed, theta
            # moves with sigma
            u = q[:, off].clone()
            sigma = tf.forward(u)
            prec = torch.zeros_like(u)
            num = torch.zeros_like(u)
            lat = []
            for zoff, zlen, mu_spec, obs_info in g["anc_t"]:
                theta = q[:, zoff:zoff + zlen]
                mu_v = _mean_value(q, mu_spec)
                z = (theta - mu_v) / sigma[:, None]
                for y_spec, s_spec in obs_info:
                    yb = _y_runtime(y_spec, data)
                    nd = yb.ndim - 1
                    if s_spec[0] == "const":
                        s_val = s_spec[1]
                    else:
                        s_val = s_spec[2].forward(q[:, s_spec[1]])
                        s_val = _event(s_val[:, None], nd)
                    w = 1.0 / (s_val * s_val)
                    z_b = _event(z, nd)
                    mu_b = _event(mu_v, nd) if torch.is_tensor(mu_v) else mu_v
                    prec = prec + xm.event_sum(w * z_b * z_b * torch.ones_like(yb))
                    num = num + xm.event_sum(w * z_b * (yb - mu_b))
                lat.append((zoff, theta, mu_v, z))
            if g["anc_mode"] == "prior":
                sigma_anc = draw(i, "u_anc", lambda: g["dist"].sample(
                    g["params_t"], (c,), generator))
                log_a2 = torch.zeros_like(u)
            else:
                prec = torch.clamp_min(prec, 1e-12)
                m_lik = num / prec
                s_lik = 1.0 / torch.sqrt(prec)
                # inverse-CDF truncated-normal draw on (0, inf)
                lo = torch.clamp(xm.ndtr(-m_lik / s_lik), 0.0, 1.0 - 1e-6)
                uu = torch.maximum(lo, draw(i, "u_anc", uniform) * (1.0 - lo) + lo)
                uu = torch.clamp(uu, 1e-7, 1.0 - 1e-7)
                sigma_anc = m_lik + s_lik * torch.special.ndtri(uu)
                log_a2 = _prior_logpdf(g, sigma_anc) - _prior_logpdf(g, sigma)
            u_prop2, ok2 = _in_domain(tf, sigma_anc)
            acc2 = (torch.log(draw(i, "u_acc2", uniform)) < log_a2) & ok2
            for zoff, theta, mu_v, z in lat:
                q[:, zoff:zoff + theta.shape[1]] = torch.where(
                    acc2[:, None], mu_v + sigma_anc[:, None] * z, theta)
            q[:, off] = torch.where(acc2, u_prop2, u)
            accepts.append(acc2.to(q.dtype))
        return q, torch.stack(accepts).mean(0)

    return step


def build_conditional_metric(model, frozen_offsets=None):
    """For ``gibbs_scales``: ``fn(q, inv) -> inv'`` setting the inverse
    mass of each group's centered-Normal latents to their analytic
    conditional variance given the current (frozen) scales,

        prec(theta_e | mu, tau, y) = 1/tau^2 + sum_obs 1/s_e^2,

    and of a coordinate mean to 1 / (prior precision + its latents'
    1/tau^2), per chain. Valid as a metric because the scales do not
    move within a trajectory. None when no group has ancillary obs info.

    A latent whose conditional needs a sampled noise scale outside
    ``frozen_offsets`` keeps the adapted metric (a metric reading a
    moving coordinate would break reversibility), with a warning."""
    groups = [g for g in eligible_groups(model) if g.get("anc")]
    if frozen_offsets is None:
        frozen_offsets = {g["offset"] for g in groups}
    groups = [g for g in groups if g["offset"] in frozen_offsets]
    if not groups:
        return None
    ir, ncp, dev = model.ir, model.ncp_info, model.device
    specs = []     # (sig_off, tf, zoff, zlen, w_const (zlen,), coord_obs)
    mu_specs = {}  # (mu_off, mu_len) -> [prec0, [(sig_off, tf, count)]]
    for g in groups:
        for zoff, zlen, mu_spec, obs_info in g["anc"]:
            w_const = np.zeros(zlen, np.float64)
            coord_obs = []
            for y_spec, s_spec in obs_info:
                y_shape = (y_spec[1].shape if y_spec[0] == "const"
                           else y_spec[2])
                if s_spec[0] == "const":
                    w = 1.0 / np.square(s_spec[1])
                    w_const += np.broadcast_to(w, y_shape).reshape(
                        -1, zlen).sum(axis=0)
                else:
                    n_per = np.ones(y_shape).reshape(-1, zlen).sum(axis=0)
                    coord_obs.append((s_spec[1], s_spec[2], n_per))
            if any(off not in frozen_offsets for off, _, _ in coord_obs):
                warnings.warn(
                    "gibbs_scales: an observation scale feeding "
                    f"group {g['sigma_id']!r}'s conditional metric is "
                    "not itself freezable (no obs-noise Gibbs group) — "
                    "its latents keep the adapted metric; expect some "
                    "divergences at small scales", stacklevel=3)
                continue
            specs.append((g["offset"], g["transform"], zoff, zlen,
                          _const(w_const, dev)[0],
                          tuple((off, tf, _const(n_per, dev)[0])
                                for off, tf, n_per in coord_obs)))
            if mu_spec is not None and mu_spec[0] == "coord":
                mkey = (mu_spec[1], mu_spec[2])
                if mkey not in mu_specs:
                    # prior precision of mu when its prior is a
                    # constant-parameter Normal, else 0
                    prec0 = 0.0
                    for nid, n in ir.nodes.items():
                        e = next((e for e in model.pm.entries
                                  if e.id == nid), None)
                        if (e is not None and e.offset == mu_spec[1]
                                and n.op[0] == "rv" and nid not in ncp
                                and get_dist(n.op[1]).name == "normal"):
                            s0 = n.op[2].get("sigma")
                            if not isinstance(s0, str):
                                prec0 = float(1.0 / np.square(
                                    np.asarray(s0, np.float64)).min())
                            break
                    mu_specs[mkey] = [prec0, []]
                count = zlen if mu_spec[2] == 1 else 1
                mu_specs[mkey][1].append((g["offset"], g["transform"], count))
    if not specs:
        return None

    def fn(q, inv):
        inv = inv.expand(q.shape).clone()
        for off, tf, zoff, zlen, w_const, coord_obs in specs:
            tau = tf.forward(q[:, off])
            prec = 1.0 / torch.clamp_min(tau * tau, 1e-20)[:, None] + w_const
            for s_off, s_tf, n_per in coord_obs:
                s_val = s_tf.forward(q[:, s_off])
                prec = prec + n_per / torch.clamp_min(s_val * s_val, 1e-20)[:, None]
            inv[:, zoff:zoff + zlen] = 1.0 / prec
        for (moff, mlen), (prec0, taus) in mu_specs.items():
            prec = torch.full_like(q[:, 0], prec0)
            for soff, stf, count in taus:
                tau = stf.forward(q[:, soff])
                prec = prec + count / torch.clamp_min(tau * tau, 1e-20)
            inv[:, moff:moff + mlen] = (1.0 / prec)[:, None]
        return inv

    return fn
