"""2D Taylor-Green vortex.

The convective term v . grad(w) vanishes identically, and lap(w) = -8 pi^2 w
(Lx = Ly = 1).
"""
import math
from math import pi

import torch

DIM = 2
LX = LY = 1.0
UREF = 1.0


def alpha(nu, t):
    return UREF * math.exp(-4 * pi**2 * nu * t * (1 / LX**2 + 1 / LY**2))


def velocity(coords, alpha=1.0):
    c = torch.as_tensor(coords)
    x = 2 * pi * c[:, 0] / LX
    y = 2 * pi * c[:, 1] / LY
    return torch.stack([torch.cos(x) * torch.sin(y) * alpha,
                        -torch.sin(x) * torch.cos(y) * alpha], dim=1)


def vorticity(coords, alpha=1.0):
    c = torch.as_tensor(coords)
    x = 2 * pi * c[:, 0] / LX
    y = 2 * pi * c[:, 1] / LY
    w = -2 * pi * (1 / LX + 1 / LY) * torch.cos(x) * torch.cos(y) * alpha
    return w[:, None]


def convective(coords, alpha=1.0):
    """curl(div(v (x) v)) = v . grad(w) = 0 for the 2D TG vortex."""
    c = torch.as_tensor(coords)
    return torch.zeros((c.shape[0], 1), dtype=c.dtype, device=c.device)


def diffusive(coords, alpha=1.0, nu=1.0):
    """nu * lap(w) = -8 pi^2 nu w."""
    return -8 * pi**2 * nu * vorticity(coords, alpha)
