"""What the many-chain ensemble engines share (``exmc_tpu/engines_common.py``):
a small LRU of compiled models keyed like the JAX package's kernel cache,
and the post-processing of an engine's outputs into the (trace, stats)
pair that ``sample`` returns.

In the JAX package the cache holds the jitted two-scan kernel. Here the
costly part is the compiled model with its CUDA graphs, one per batch
shape it has met (the chain batch, MEADS's folds), so the cache holds
the model and the engine's per-run constants.
"""

from collections import OrderedDict

from exmc_tpu_torch.compiler import CompiledModel, compile_logp, constrainer
from exmc_tpu_torch.config import default_dtype, prepare_device


class KernelCache:
    """LRU of (model, kernel) keyed on (model signature, the engine's
    hyperparameters, dtype, device)."""

    def __init__(self, maxsize=8):
        self._cache = OrderedDict()
        self._maxsize = maxsize

    def clear(self):
        self._cache.clear()

    @staticmethod
    def model_sig(ir, ncp):
        """Identity for a compiled model, the IR's structural signature
        otherwise."""
        from exmc_tpu_torch.nuts.sampler import ir_signature

        if isinstance(ir, CompiledModel):
            return ("model-id", id(ir))
        return ("ir", ir_signature(ir), bool(ncp))

    def get_or_build(self, key, ir, ncp, device, builder):
        """The cached (model, kernel) for ``key``, or the model compiled
        (unless ``ir`` is one) and ``builder()``'s kernel, cached."""
        dev = ir.device if isinstance(ir, CompiledModel) else prepare_device(device)
        key = key + (str(default_dtype()), str(dev))
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        model = (ir if isinstance(ir, CompiledModel)
                 else compile_logp(ir, ncp=ncp, device=dev))
        entry = (model, builder())
        self._cache[key] = entry
        while len(self._cache) > self._maxsize:
            self._cache.popitem(last=False)
        return entry


def run_data(ir, model, data):
    """The run's data as a ``DeviceData`` (None: the model's own,
    captured): ``data``, else the IR's own ``Builder.data``, which a
    cached model compiled from another IR does not hold."""
    if data is None and not isinstance(ir, CompiledModel):
        data = ir.data
    return None if data is None else model.device_data(data)


def postprocess_ensemble(outs, model, ddata, return_unconstrained, extra_stats):
    """Chains-first outputs (chains, samples, ...) -> (trace, stats): the
    stats as numpy, the per-chain divergence count, and the constrained
    named draws (unless ``return_unconstrained``)."""
    draws = outs["q"]
    stats = {k: outs[k].cpu().numpy()
             for k in ("logp", "accept_prob", "diverging", "energy")}
    stats.update(extra_stats)
    stats["divergences"] = stats["diverging"].sum(axis=-1)
    if return_unconstrained:
        return draws.cpu().numpy(), stats
    c, s, d = draws.shape
    named = constrainer(model.ir, model.pm, model.device,
                        model.data if ddata is None else ddata)(
        draws.reshape(c * s, d).to(default_dtype()))
    trace = {k: v.reshape((c, s) + tuple(v.shape[1:])).cpu().numpy()
             for k, v in named.items()}
    return trace, stats
