"""A logistic regression at the size of the UCI covertype set, built
through the port's ``glm``. The rows are made on the card from the seed
in float32, the type the port serves them in, and standardised there;
the same host arrays go to the program and to the reference."""

import torch

from exmc_tpu_torch import Model
from exmc_tpu_torch.glm import glm


def build(cfg, seed, device):
    """(ir, data): the model's IR and the arrays the reference reads."""
    n, p = cfg["rows"], cfg["columns"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.randn(n, p, generator=gen, device=device, dtype=torch.float32)
    x = (x - x.mean(0)) / x.std(0)
    coef = torch.randn(p, generator=gen, device=device, dtype=torch.float32)
    eta = x @ (coef * cfg["true_coef_sd"])
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    y = (u < torch.sigmoid(eta)).to(torch.float32)
    x, y = x.cpu().numpy(), y.cpu().numpy()
    with Model() as m:
        glm(m, x, y, family=cfg["family"], intercept=cfg["intercept"])
    return m.ir, {"X": x, "y": y}


def vag_flops(cfg, chains):
    """Floating-point operations of one value-and-grad of ``chains``
    points: the forward product X b (2 N D C) and the backward X^T r
    (2 N D C). The elementwise likelihood (about 10 operations a row and
    chain, some 3 % more) is not counted, so a share of the peak reads
    low rather than high."""
    return 4.0 * cfg["rows"] * cfg["columns"] * chains


def vag_bytes(cfg, chains):
    """Bytes that one value-and-grad has to move at the least: X and y
    read once in float32; the (chains, rows) logits need never reach
    memory, and the points and gradients are a few kilobytes."""
    return 4.0 * cfg["rows"] * (cfg["columns"] + 1) + 8.0 * chains * (cfg["columns"] + 1)

