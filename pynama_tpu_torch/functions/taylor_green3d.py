"""3D Taylor-Green-like vortex."""
import math
from math import pi

import torch

DIM = 3
LX = LY = LZ = 1.0
UREF = 1.0


def alpha(nu, t):
    return UREF * math.exp(-4 * pi**2 * nu * t
                           * (1 / LX**2 + 1 / LY**2 + 1 / LZ**2))


def _angles(coords):
    c = torch.as_tensor(coords)
    return (2 * pi * c[:, 0] / LX, 2 * pi * c[:, 1] / LY,
            2 * pi * c[:, 2] / LZ)


def velocity(coords, alpha=1.0):
    x, y, z = _angles(coords)
    return torch.stack([
        torch.cos(x) * torch.sin(y) * torch.sin(z) * LX * alpha,
        torch.sin(x) * torch.cos(y) * torch.sin(z) * LY * alpha,
        -2 * torch.sin(x) * torch.sin(y) * torch.cos(z) * LZ * alpha], dim=1)


def vorticity(coords, alpha=1.0):
    x, y, z = _angles(coords)
    return torch.stack([
        -2 * pi * (LY / LZ + 2 * LZ / LY) * torch.sin(x) * torch.cos(y)
        * torch.cos(z) * alpha,
        2 * pi * (LX / LZ + 2 * LZ / LX) * torch.cos(x) * torch.sin(y)
        * torch.cos(z) * alpha,
        2 * pi * (LY / LX - LX / LY) * torch.cos(x) * torch.cos(y)
        * torch.sin(z) * alpha], dim=1)


def convective(coords, alpha=1.0):
    x, y, z = _angles(coords)
    k = (2 * pi * alpha) ** 2
    return torch.stack([
        -2 * (2 * LZ / LY + LY / LZ) * k * torch.sin(y) * torch.cos(y)
        * torch.sin(z) * torch.cos(z),
        2 * (2 * LZ / LX + LX / LZ) * k * torch.sin(x) * torch.cos(x)
        * torch.sin(z) * torch.cos(z),
        2 * (2 * LX / LY - 2 * LY / LX) * k * torch.sin(y) * torch.cos(y)
        * torch.sin(x) * torch.cos(x)], dim=1)


def diffusive(coords, alpha=1.0, nu=1.0):
    """nu * lap(w), the nu factor included (the solver's diffusive operator
    carries it)."""
    x, y, z = _angles(coords)
    k3 = (2 * pi) ** 3 * alpha * nu
    c1 = (2 * (LZ / (LX * LX * LY) + LZ / (LY**3) + LZ / (LZ * LZ * LY))
          + LY / (LX * LX * LZ) + LY / (LY * LY * LZ) + LY / (LZ**3))
    c2 = (2 * (LZ / (LX**3) + LZ / (LY * LY * LX) + LZ / (LZ * LZ * LX))
          + LX / (LX * LX * LZ) + LX / (LY * LY * LZ) + LX / (LZ**3))
    c3 = (LX / (LX * LX * LY) + LX / (LY**3) + LX / (LZ * LZ * LY)
          - LY / (LX**3) - LY / (LY * LY * LX) - LY / (LZ * LZ * LX))
    return torch.stack([
        k3 * torch.sin(x) * torch.cos(y) * torch.cos(z) * c1,
        -k3 * torch.cos(x) * torch.sin(y) * torch.cos(z) * c2,
        k3 * torch.cos(x) * torch.cos(y) * torch.sin(z) * c3], dim=1)
