"""A model's log-density at a named point (``exmc_tpu/log_prob.py``): a
convenience over the compiled ``logp`` that takes named values instead
of flat vectors."""

from exmc_tpu_torch.compiler import CompiledModel, compile_logp


def eval(ir, values, data=None, *, ncp=True, constrained=True, device=None):
    """log p at a named value map {free-RV name: value of one point}, as
    a 0-d tensor. With ``constrained=True`` (default) the values lie in
    the dists' supports and are pulled back through the inverse
    transforms (the trace's convention); with ``constrained=False`` they
    are unconstrained z values packed as they are. Either way it equals
    the compiled ``logp`` at the corresponding flat point, transform
    Jacobians included."""
    model = ir if isinstance(ir, CompiledModel) else compile_logp(ir, ncp=ncp, device=device)
    if data is None:
        data = model.data
    if constrained:
        flat = model.unconstrain(values)
    else:
        flat = model.pm.pack(values)[0]
    return model.logp(flat.to(model.device).unsqueeze(0), data)[0]
