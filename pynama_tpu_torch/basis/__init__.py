from pynama_tpu_torch.basis.quadrature import gauss_points, lobatto_points
from pynama_tpu_torch.basis.lagrange import lagrange_basis
from pynama_tpu_torch.basis.tables import (Basis1D, TensorBasis,
                                           make_tensor_basis)
