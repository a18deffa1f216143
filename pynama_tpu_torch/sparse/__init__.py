from pynama_tpu_torch.sparse.formats import COO, CSR, ELL, BSR
from pynama_tpu_torch.sparse.assemble import assemble_coo, coo_to_csr, \
    csr_to_ell, csr_to_bsr, assemble_from_elements
from pynama_tpu_torch.sparse.spmv import spmv, spmv_csr, spmv_ell, spmv_bsr
from pynama_tpu_torch.sparse.spgemm import spgemm
