"""counts.py reproduces the bounds the port's records give (PERF.md's
kernel table: K1 at 24^3 ngl=4 and 25^3 ngl=3, f32, in µs)."""
import pytest

import bench_paths  # noqa: F401 (puts the benchmark on sys.path)
import counts


@pytest.mark.parametrize("nelem,ngl,shapes,want", [
    ((24, 24, 24), 4, [(3, 3), (3, 6), (6, 3)], [15.2, 30.4, 30.4]),
    ((25, 25, 25), 3, [(3, 3), (3, 6), (6, 3)], [3.07, 6.12, 6.12]),
])
def test_k1_bounds(nelem, ngl, shapes, want):
    got = [1e6 * counts.apply_bound_s(nelem, ngl, ci, co, "float32")
           for ci, co in shapes]
    assert [round(g, 2 if w < 10 else 1) for g, w in zip(got, want)] == want


def test_bound_sides():
    f, b = counts.apply_cost((25, 25, 25), 3, 3, 3, "float32")
    assert counts.bound_s(f, b, "float32")[1] == "bytes"
    f, b = counts.apply_cost((24, 24, 24), 4, 3, 3, "float32")
    assert counts.bound_s(f, b, "float32")[1] == "operations"
    assert f == 2 * 13824 * 192 * 192


@pytest.mark.parametrize("dim,two_stage,want", [
    (3, True, [(3, 3)] * 8 + [(3, 6), (6, 3)]),
    (2, True, [(1, 2), (2, 2), (2, 2)] * 2 + [(2, 1), (2, 3), (3, 2),
                                              (2, 1)]),
    (3, False, [(3, 3)] * 4 + [(3, 6), (6, 3)])])
def test_rhs_applications(dim, two_stage, want):
    assert sorted(counts.rhs_applications(dim, two_stage)) == sorted(want)


def test_fdm_cost_grows_with_grid():
    f1, b1 = counts.fdm_apply_cost((73, 73, 73), 3, "float32")
    f2, b2 = counts.fdm_apply_cost((37, 37, 37), 3, "float32")
    assert f1 > 8 * f2 * 0.9 and b1 > 7 * b2
