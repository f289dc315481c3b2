"""Python model-building DSL of the port (``exmc_tpu/dsl.py``).

The reference's macro DSL (reference dsl.ex:18-69) binds a hidden ``ir``
variable inside ``model do ... end``. The Python-idiomatic equivalent is a
context manager accumulating Builder calls::

    from exmc_tpu_torch import Model, dists

    with Model() as m:
        m.rv("mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
        m.rv("sigma", dists.HalfNormal, {"sigma": 1.0})
        m.rv("y", dists.Normal, {"mu": "mu", "sigma": "sigma"})
        m.obs("y_obs", "y", y_data)

    ir = m.ir
"""

from exmc_tpu_torch.ir import Builder


class Model:
    """Context-manager model builder; each method mirrors Builder."""

    def __init__(self):
        self.ir = Builder.new_ir()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def rv(self, node_id, dist, params, *, transform=None, shape=None):
        self.ir = Builder.rv(
            self.ir, node_id, dist, params, transform=transform, shape=shape
        )
        return node_id

    def obs(self, node_id, rv_id, value, **meta):
        self.ir = Builder.obs(self.ir, node_id, rv_id, value, **meta)
        return node_id

    def det(self, node_id, fn, args):
        self.ir = Builder.det(self.ir, node_id, fn, args)
        return node_id

    def data(self, tensor):
        self.ir = Builder.data(self.ir, tensor)

    def matmul(self, node_id, a, rv_id):
        """Shorthand for a matmul det node (reference dsl.ex:56-60)."""
        return self.det(node_id, "matmul", [a, rv_id])

    def affine(self, node_id, a, b, rv_id):
        """Shorthand for affine a*rv + b (reference dsl.ex:63-69)."""
        return self.det(node_id, "affine", [a, b, rv_id])
