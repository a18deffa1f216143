from pynama_tpu_torch.mesh.box import BoxMesh
from pynama_tpu_torch.mesh.gmsh import GmshData, read_msh
from pynama_tpu_torch.mesh.unstructured import UnstructuredMesh
from pynama_tpu_torch.mesh.unstructured3d import HexMesh


def mesh_from_gmsh(path: str, ngl: int):
    """Load a gmsh file into the right mesh type (2D quads or 3D hexes)."""
    data = read_msh(path)
    if data.is_3d:
        return HexMesh.create(ngl, data.vertices, data.hexes, data.surfaces)
    return UnstructuredMesh.create(ngl, data.vertices, data.quads,
                                   data.lines)
