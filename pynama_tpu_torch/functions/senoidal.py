"""Sinusoidal 2D verification field (time-independent: alpha is 1.0)."""
from math import pi

import torch

DIM = 2
WREF_X = 4.0
WREF_Y = 2.0


def alpha(nu, t):
    return 1.0


def _angles(coords):
    c = torch.as_tensor(coords)
    return WREF_Y * pi * c[:, 1], WREF_X * pi * c[:, 0]


def velocity(coords, alpha=1.0):
    x, y = _angles(coords)
    return torch.stack([torch.sin(x), torch.sin(y)], dim=1)


def vorticity(coords, alpha=1.0):
    x, y = _angles(coords)
    w = WREF_X * pi * torch.cos(y) - WREF_Y * pi * torch.cos(x)
    return w[:, None]


def convective(coords, alpha=1.0):
    x, y = _angles(coords)
    c = ((WREF_Y * pi) ** 2 - (WREF_X * pi) ** 2) * torch.sin(x) * torch.sin(y)
    return c[:, None]


def diffusive(coords, alpha=1.0, nu=1.0):
    x, y = _angles(coords)
    d = -(WREF_X * pi) ** 3 * torch.cos(y) + (WREF_Y * pi) ** 3 * torch.cos(x)
    return nu * d[:, None]
