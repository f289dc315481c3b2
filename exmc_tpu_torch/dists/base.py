"""Distribution protocol and registry, keyed by ``Distribution.name``
(the same names as ``exmc_tpu.dists``, so one model script can build the
IR of either package).

``logpdf(value, params)`` is elementwise: ``value`` and every tensor in
``params`` already broadcast against each other (the compiler aligns a
leading chain dim and the event dims), and the result has the
broadcast shape. Sums over event axes are the compiler's job.

``sample(params, shape, generator)`` draws from the distribution with
an explicit ``torch.Generator``, on the generator's device, in float32.
"""


class Distribution:
    name = "distribution"

    def logpdf(self, value, params):
        raise NotImplementedError

    def default_transform(self, params):
        """Name of the default constraint transform, or None."""
        return None

    def sample(self, params, shape, generator):
        raise NotImplementedError(
            f"{self.name}.sample is not ported yet (ROADMAP §1)")

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
        raise ValueError(
            f"unknown distribution: {name!r} (the port has "
            f"{sorted(_REGISTRY)}; the rest is ROADMAP §1 item 1)") from None
