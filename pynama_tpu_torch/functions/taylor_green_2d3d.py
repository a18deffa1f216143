"""2D Taylor-Green flow embedded in a 3D domain."""
import math
from math import pi

import torch

DIM = 3
LX = LY = 1.0
UREF = 1.0


def alpha(nu, t):
    return UREF * math.exp(-4 * pi**2 * nu * t * (1 / LX**2 + 1 / LY**2))


def velocity(coords, alpha=1.0):
    c = torch.as_tensor(coords)
    x = 2 * pi * c[:, 0] / LX
    y = 2 * pi * c[:, 1] / LY
    z = torch.zeros_like(x)
    return torch.stack([torch.cos(x) * torch.sin(y) * LX * alpha,
                        -torch.sin(x) * torch.cos(y) * LY * alpha, z], dim=1)


def vorticity(coords, alpha=1.0):
    c = torch.as_tensor(coords)
    x = 2 * pi * c[:, 0] / LX
    y = 2 * pi * c[:, 1] / LY
    wz = -2 * pi * (LY / LX + LX / LY) * torch.cos(x) * torch.cos(y) * alpha
    zero = torch.zeros_like(wz)
    return torch.stack([zero, zero, wz], dim=1)


def convective(coords, alpha=1.0):
    c = torch.as_tensor(coords)
    return torch.zeros((c.shape[0], 3), dtype=c.dtype, device=c.device)


def diffusive(coords, alpha=1.0, nu=1.0):
    return -8 * pi**2 * nu * vorticity(coords, alpha)
