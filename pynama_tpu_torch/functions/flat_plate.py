"""Impulsively-started flat plate (Stokes' first problem) fields.

alpha(nu, t) returns tau = sqrt(4 nu t) and the fields take tau. At t = 0,
tau = 0 and the fields are inf/NaN exactly as IEEE arithmetic makes them:
the scalar factors are divided in numpy float64, which gives inf where a
Python float division would raise.
"""
import math
from math import pi

import numpy as np
import torch

DIM = 2
UREF = 1.0


def alpha(nu, t):
    return math.sqrt(4.0 * nu * t)


def _div(a, b):
    """a / b for host scalars with IEEE semantics (inf or NaN at b = 0);
    a tensor b divides as a tensor."""
    if isinstance(b, torch.Tensor):
        return a / b
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(a) / np.float64(b))


def velocity(coords, alpha):
    c = torch.as_tensor(coords)
    tau = alpha
    vx = UREF * torch.erf(c[:, 1] / tau)
    vy = torch.ones_like(vx)
    return torch.stack([vx, vy], dim=1)


def vorticity(coords, alpha):
    c = torch.as_tensor(coords)
    tau = alpha
    w = _div(-2.0, tau * math.sqrt(pi)) * torch.exp(-(c[:, 1] / tau) ** 2)
    return w[:, None]


def convective(coords, alpha):
    c = torch.as_tensor(coords)
    tau = alpha
    out = (4.0 * c[:, 1] / (math.sqrt(pi) * tau**3)) \
        * torch.exp(-(c[:, 1] / tau) ** 2)
    return out[:, None]


def diffusive(coords, alpha, nu=1.0):
    c = torch.as_tensor(coords)
    tau = alpha
    a = _div(4.0, math.sqrt(pi) * tau**3)
    b = 1.0 - 2.0 * c[:, 1] ** 2 / tau**2
    d = nu * a * b * torch.exp(-(c[:, 1] / tau) ** 2)
    return d[:, None]
