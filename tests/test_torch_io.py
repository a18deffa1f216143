"""The port's io/ (XdmfWriter, Paraviewer, checkpoints) against the JAX
package's: the same inputs through both, the files they write compared
(HDF5 dataset by dataset and bit for bit, text files byte for byte), and
each package reading the other's checkpoint."""
import h5py
import numpy as np
import pytest

from pynama_tpu import io as jio
from pynama_tpu_torch import io as tio


def _inputs(dim, n=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)), rng.standard_normal((n, dim)),
            rng.standard_normal((n, 1 if dim == 2 else 3)))


def _h5(path):
    with h5py.File(path, "r") as f:
        out = {}
        f.visititems(lambda k, v: out.__setitem__(k, v[()]) if isinstance(
            v, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("dim", [2, 3])
def test_xdmf_writer_matches(tmp_path, dim):
    paths = {}
    for name, mod in (("jax", jio), ("torch", tio)):
        x = mod.XdmfWriter(dim)
        x.set_nodes(17)
        x.build_template()
        for step, t in ((0, 0.0), (3, 0.125), (12, 1.0 / 3.0)):
            g = x.add_step_grid("mesh1")
            x.set_time(t, g)
            x.add_vector("velocity", step, g)
            x.add_scalar("speed", step, g)
        paths[name] = tmp_path / name
        x.write(str(paths[name]))
    txt = (tmp_path / "torch.xmf").read_text()
    assert txt == (tmp_path / "jax.xmf").read_text()
    assert "Polyvertex" in txt and ("JOIN($0, $1)" if dim == 2
                                    else "JOIN($0, $1, $2)") in txt


@pytest.mark.parametrize("dim", [2, 3])
def test_paraviewer_matches(tmp_path, monkeypatch, dim):
    """mesh.h5, vec-data-<step>.h5, the .xmf index, a VTK point cloud and
    the yaml sidecar, written by both packages from the same arrays."""
    coords, vel, vort = _inputs(dim)
    for name, mod in (("jax", jio), ("torch", tio)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        v = mod.Paraviewer()
        v.configure(dim, "out")
        v.save_mesh(coords)
        v.save_data(3, 0.125, velocity=vel, vorticity=vort)
        v.save_data(4, 0.25, velocity=2 * vel.astype(np.float32),
                    vorticity=3 * vort)
        v.write_xmf("case")
        v.write_vtk("m", coords, step=4, speed=np.abs(vel[:, 0]), vel=vel)
        v.write_vtk("m", coords)
        v.write_yaml("case", {"name": "case", "steps": [3, 4]})
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    files = sorted(p.name for p in (dt / "out").iterdir())
    assert files == sorted(p.name for p in (dj / "out").iterdir()) == [
        "case.xmf", "m-00004.vtk", "m.vtk", "mesh.h5", "vec-data-00003.h5",
        "vec-data-00004.h5"]
    for f in files:
        if f.endswith(".h5"):
            a, b = _h5(dj / "out" / f), _h5(dt / "out" / f)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert (dt / "out" / f).read_text() == \
                (dj / "out" / f).read_text()
    assert (dt / "out.yaml").read_text() == (dj / "out.yaml").read_text()
    mesh = _h5(dt / "out" / "mesh.h5")["fields/mesh"]
    np.testing.assert_array_equal(mesh, coords.ravel())
    snap = _h5(dt / "out" / "vec-data-00004.h5")
    assert snap["fields/velocity"].dtype == np.float32


def test_checkpoint_cross_load(tmp_path):
    """Each package reads the checkpoint the other wrote."""
    _, vel, vort = _inputs(2, n=20, seed=1)
    for w, r in ((jio, tio), (tio, jio)):
        path = str(tmp_path / f"{w.__name__}.h5")
        w.save_checkpoint(path, vort, vel, t=0.5, dt=1e-3, step=7,
                          config={"name": "x"})
        ck = r.load_checkpoint(path)
        np.testing.assert_array_equal(ck["vorticity"], vort)
        np.testing.assert_array_equal(ck["velocity"], vel)
        assert (ck["t"], ck["dt"], ck["step"]) == (0.5, 1e-3, 7)
        assert ck["config"] == {"name": "x"}
    w = tio.save_checkpoint
    w(str(tmp_path / "nocfg.h5"), vort, vel, 0.0, 0.0, 0)
    assert tio.load_checkpoint(str(tmp_path / "nocfg.h5"))["config"] is None
