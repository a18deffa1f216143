"""Meshes the benchmark writes at set-up from a configuration's numbers
(`hex_cube.py`: the distorted hexahedral cube of the gmsh-file cells)."""
