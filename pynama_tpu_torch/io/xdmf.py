"""XDMF 2.0 time-series index generation for ParaView.

Functional port of the reference's XmlGenerator (`src/viewer/
xml_generator.py:4-147`): a Polyvertex point cloud whose geometry lives in
`mesh.h5:/fields/mesh` and per-step fields in `vec-data-<step>.h5:/fields/
<name>`, all stored as flat interleaved arrays (the PETSc Vec layout).
Vector attributes are assembled from per-component HyperSlabs JOINed
together; scalars reference the flat array directly.
"""
from __future__ import annotations

from xml.dom import minidom
from xml.etree.ElementTree import Element, SubElement, tostring

_JOIN = {2: "JOIN($0, $1)", 3: "JOIN($0, $1, $2)"}
_DOFS = ["X", "Y", "Z"]


class XdmfWriter:
    def __init__(self, dim: int, h5name: str = "vec-data"):
        self.dim = dim
        self.h5name = h5name
        self.n_nodes = None
        self.root = Element("Xdmf")
        self.root.set("Version", "2.0")

    def set_nodes(self, total_nodes: int):
        self.n_nodes = int(total_nodes)

    def build_template(self):
        self.domain = SubElement(self.root, "Domain")
        self.grid = SubElement(self.domain, "Grid")
        self.grid.set("Name", "TimeSeries")
        self.grid.set("GridType", "Collection")
        self.grid.set("CollectionType", "Temporal")

    def add_step_grid(self, name: str = "mesh1"):
        g = SubElement(self.grid, "Grid")
        g.set("Name", name)
        g.set("GridType", "uniform")
        topo = SubElement(g, "Topology")
        topo.set("TopologyType", "Polyvertex")
        topo.set("Dimensions", str(self.n_nodes))
        geom = SubElement(g, "Geometry")
        geom.set("GeometryType", "XY" if self.dim == 2 else "XYZ")
        gd = SubElement(geom, "DataItem")
        gd.set("Dimensions", str(self.n_nodes * self.dim))
        gd.set("NumberType", "Float")
        gd.set("Format", "HDF")
        gd.text = "mesh.h5:/fields/mesh"
        return g

    def set_time(self, t: float, grid):
        ts = SubElement(grid, "Time")
        ts.set("Value", str(t))

    def add_vector(self, name: str, step: int, grid, ncomp=None):
        ncomp = self.dim if ncomp is None else ncomp
        attr = SubElement(grid, "Attribute")
        attr.set("Name", name)
        attr.set("AttributeType", "Vector")
        attr.set("Center", "Node")
        data = SubElement(attr, "DataItem")
        data.set("ItemType", "Function")
        data.set("Dimensions", f"{self.n_nodes} {ncomp}")
        data.set("Function", _JOIN[ncomp])
        for c in range(ncomp):
            self._add_hyperslab(data, step, name, c, ncomp)

    def add_scalar(self, name: str, step: int, grid):
        attr = SubElement(grid, "Attribute")
        attr.set("Name", name)
        attr.set("AttributeType", "Scalar")
        attr.set("Center", "Node")
        data = SubElement(attr, "DataItem")
        data.set("Dimensions", str(self.n_nodes))
        data.set("NumberType", "Float")
        data.set("Format", "HDF")
        data.text = f"{self.h5name}-{step:05d}.h5:/fields/{name}"

    def _add_hyperslab(self, parent, step, name, comp, ncomp):
        """One strided component slice of the flat interleaved array."""
        hs = SubElement(parent, "DataItem")
        hs.set("ItemType", "HyperSlab")
        hs.set("Dimensions", str(self.n_nodes))
        hs.set("Name", f"{name}-{_DOFS[comp]}")
        dims = SubElement(hs, "DataItem")
        dims.set("Dimensions", "3 1")
        dims.set("Format", "XML")
        dims.text = f"{comp} {ncomp} {self.n_nodes}"
        src = SubElement(hs, "DataItem")
        src.set("Dimensions", str(self.n_nodes * ncomp))
        src.set("NumberType", "Float")
        src.set("Format", "HDF")
        src.text = f"{self.h5name}-{step:05d}.h5:/fields/{name}"

    def write(self, path: str):
        rough = tostring(self.root, "utf-8")
        pretty = minidom.parseString(rough).toprettyxml(indent=" ")
        with open(f"{path}.xmf", "w") as f:
            f.write(pretty)
