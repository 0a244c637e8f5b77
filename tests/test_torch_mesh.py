"""Port parity: the port's mesh generator (a numpy copy) is bit-equal to the
reference's, and ``convert.mesh_from_arrays`` carries a reference mesh over."""
import dataclasses

import numpy as np
import pytest

from repro.fem import meshgen as ref_meshgen, quadrature as ref_quad
from repro_torch import convert
from repro_torch.fem import meshgen, quadrature

CASES = [((3, 3, 3), 8), ((2, 2, 2), 4)]


def _assert_mesh_equal(port, ref):
    for f in dataclasses.fields(ref_meshgen.Mesh):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "materials":
            assert [dataclasses.asdict(m) for m in a] == [dataclasses.asdict(m) for m in b]
        elif f.name == "npad":
            assert a == b
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("n,pad", CASES)
def test_mesh_arrays_bit_equal(n, pad):
    _assert_mesh_equal(meshgen.generate(*n, pad_elems_to=pad), ref_meshgen.generate(*n, pad_elems_to=pad))


def test_quadrature_tables_bit_equal():
    for name in ("GAUSS_POINTS", "GAUSS_WEIGHTS", "GRADN_REF"):
        np.testing.assert_array_equal(getattr(quadrature, name), getattr(ref_quad, name))


@pytest.mark.parametrize("as_dict", [False, True])
def test_mesh_from_arrays_carries_reference_mesh(as_dict):
    ref = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    src = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)} if as_dict else ref
    port = convert.mesh_from_arrays(src)
    assert isinstance(port, meshgen.Mesh)
    _assert_mesh_equal(port, ref)
    assert [m.G0 for m in port.materials] == [m.G0 for m in ref.materials]
