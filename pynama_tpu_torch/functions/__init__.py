"""Analytic solution fields (verification oracles), written with torch ops.

Carried over from pynama_tpu/functions/: the 2D and 3D Taylor-Green
vortices, the 2D Taylor-Green flow embedded in 3D, and the senoidal and
flat-plate (Stokes' first problem) fields.

Field signature convention:
  alpha(nu, t) -> Python float decay factor (host arithmetic: a boundary
                  write per right-hand side puts no scalar on the device)
  velocity(coords, alpha)   -> (n, dim)
  vorticity(coords, alpha)  -> (n, dim_w)
  convective(coords, alpha) -> (n, dim_w)
  diffusive(coords, alpha, nu) -> (n, dim_w)

`coords` is an (n, dim) numpy array or tensor; the result is a tensor on
that device, in that dtype (a numpy array gives a CPU tensor).
"""
from pynama_tpu_torch.functions import (flat_plate, senoidal, taylor_green,
                                        taylor_green3d, taylor_green_2d3d)

REGISTRY = {
    "taylor_green": taylor_green,
    "taylor_green3d": taylor_green3d,
    # the reference's file name for the 2D flow embedded in 3D
    "taylor_green_3d": taylor_green_2d3d,
    "taylor_green_2d3d": taylor_green_2d3d,
    "senoidal": senoidal,
    "flat_plate": flat_plate,
}


def get_function_lib(name: str):
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown analytic function library '{name}'; "
                       f"available: {sorted(REGISTRY)}")
