"""Distribution protocol and registry, keyed by ``Distribution.name``
(the same names as ``exmc_tpu.dists``, so one model script can build the
IR of either package).

``logpdf(value, params)`` works on batched tensors with a leading chain
axis (1 for constants). Before the call the compiler aligns ``value``
and every tensor in ``params`` on their batch axes: the axes between the
chain axis and the trailing *event* axes each tensor carries by itself
(``value_event_dims``; ``param_event_dims`` per parameter, 0 when not
listed), so batch axes broadcast right-aligned as they do for one point
in JAX. A univariate logpdf is elementwise; a multivariate one reduces
its value's event axes. Sums over the remaining axes are the compiler's
job.

``sample(params, shape, generator)`` draws with an explicit
``torch.Generator``, on the generator's device, in float32.
"""


class Distribution:
    name = "distribution"
    value_event_dims = 0
    param_event_dims = {}
    align = True

    def logpdf(self, value, params):
        raise NotImplementedError

    def support(self, params):
        """One of "real", "positive", "unit", "simplex", or a custom tag."""
        return "real"

    def default_transform(self, params):
        """Name of the default constraint transform, or None."""
        return None

    def sample(self, params, shape, generator):
        raise NotImplementedError(f"{self.name} has no sampler")

    def prepare_params(self, params):
        """Pre-process constant params once, at compile time."""
        return params

    def validate_ir_params(self, params):
        """Compile-time check on the raw IR params (string refs intact)."""

    def __repr__(self):
        return f"<dist:{self.name}>"


_REGISTRY = {}


def register(dist):
    _REGISTRY[dist.name] = dist
    return dist


def get(name):
    if isinstance(name, Distribution):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown distribution: {name!r}") from None


def all_dists():
    return dict(_REGISTRY)
