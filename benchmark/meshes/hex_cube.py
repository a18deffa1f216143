"""The unit cube as a grid of distorted hexahedra: its vertices, its
element corners, its MSH 2.2 file, and the canonical node order both sides
of a comparison on it use.

The grid has nelem = (nx, ny, nz) hexes on [0, 1]^3; every vertex off the
boundary moves by uniform(-1, 1) * distort / nx per coordinate, drawn from
numpy's default_rng(rng) in vertex order (x slowest). With rng 0 the
vertices and the file are those of the measured package's bench.py mesh
(`pynama_tpu_torch.exp.write_hex_msh`), byte for byte: hexes in gmsh's
corner order, the boundary quads in the physical groups
down/right/up/left/back/front, the volume last.

The file is written for the program, which reads it back through its own
gmsh reader; the plain reference takes the corners from `corners` and
never reads the file.
"""
from __future__ import annotations

import itertools

import numpy as np

SIDES = ("down", "right", "up", "left", "back", "front")


def vertices(nelem, distort: float, rng: int = 0) -> np.ndarray:
    """(nx+1, ny+1, nz+1, 3) float64 vertex coordinates."""
    nx, ny, nz = (int(n) for n in nelem)
    xs = [np.linspace(0, 1, n + 1) for n in (nx, ny, nz)]
    verts = np.stack([g.ravel() for g in np.meshgrid(*xs, indexing="ij")],
                     axis=1)
    interior = np.all((verts > 1e-12) & (verts < 1 - 1e-12), axis=1)
    draw = np.random.default_rng(rng).uniform(-1, 1,
                                              (int(interior.sum()), 3))
    verts[interior] += draw * distort / nx
    return verts.reshape(nx + 1, ny + 1, nz + 1, 3)


def corners(nelem, distort: float, rng: int = 0) -> np.ndarray:
    """(E, 8, 3) corners of every hex in tensor order (corner (a0, a1, a2)
    at vertex (i + a0, j + a1, k + a2), a0 slowest); hexes in C order over
    (i, j, k)."""
    v = vertices(nelem, distort, rng)
    nx, ny, nz = (int(n) for n in nelem)
    out = np.empty((nx, ny, nz, 8, 3))
    for c, (a, b, d) in enumerate(itertools.product((0, 1), repeat=3)):
        out[:, :, :, c] = v[a:a + nx, b:b + ny, d:d + nz]
    return out.reshape(-1, 8, 3)


def write_msh(path: str, nelem, distort: float, rng: int = 0) -> str:
    """The mesh as MSH 2.2 at `path`; returns path."""
    nx, ny, nz = (int(n) for n in nelem)
    verts = vertices(nelem, distort, rng).reshape(-1, 3)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    hexes = [[vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k),
              vid(i, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
              vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)]
             for i in range(nx) for j in range(ny) for k in range(nz)]
    quads = {
        "down": [[vid(i, 0, k), vid(i + 1, 0, k), vid(i + 1, 0, k + 1),
                  vid(i, 0, k + 1)] for i in range(nx) for k in range(nz)],
        "up": [[vid(i, ny, k), vid(i + 1, ny, k), vid(i + 1, ny, k + 1),
                vid(i, ny, k + 1)] for i in range(nx) for k in range(nz)],
        "left": [[vid(0, j, k), vid(0, j + 1, k), vid(0, j + 1, k + 1),
                  vid(0, j, k + 1)] for j in range(ny) for k in range(nz)],
        "right": [[vid(nx, j, k), vid(nx, j + 1, k), vid(nx, j + 1, k + 1),
                   vid(nx, j, k + 1)] for j in range(ny) for k in range(nz)],
        "back": [[vid(i, j, 0), vid(i + 1, j, 0), vid(i + 1, j + 1, 0),
                  vid(i, j + 1, 0)] for i in range(nx) for j in range(ny)],
        "front": [[vid(i, j, nz), vid(i + 1, j, nz), vid(i + 1, j + 1, nz),
                   vid(i, j + 1, nz)] for i in range(nx) for j in range(ny)],
    }
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$PhysicalNames",
             str(len(SIDES) + 1)]
    lines += [f'2 {t + 1} "{n}"' for t, n in enumerate(SIDES)]
    lines += [f'3 {len(SIDES) + 1} "volume"', "$EndPhysicalNames",
              "$Nodes", str(len(verts))]
    lines += [f"{i + 1} {v[0]} {v[1]} {v[2]}" for i, v in enumerate(verts)]
    lines += ["$EndNodes", "$Elements",
              str(sum(len(q) for q in quads.values()) + len(hexes))]
    eid = 1
    for t, n in enumerate(SIDES):
        for q in quads[n]:
            lines.append(f"{eid} 3 2 {t + 1} {t + 1} "
                         + " ".join(str(x + 1) for x in q))
            eid += 1
    vol = len(SIDES) + 1
    for h in hexes:
        lines.append(f"{eid} 5 2 {vol} {vol} "
                     + " ".join(str(x + 1) for x in h))
        eid += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def canonical_order(coords) -> np.ndarray:
    """The permutation that sorts nodes lexicographically by (z, y, x),
    each rounded to 1e-9: `fields[order]` is a field in canonical order,
    the same on two node sets that differ by rounding alone."""
    c = np.round(np.asarray(coords, dtype=np.float64), 9)
    return np.lexsort((c[:, 0], c[:, 1], c[:, 2]))
