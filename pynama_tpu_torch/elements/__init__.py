from pynama_tpu_torch.elements.kle import (
    ElementMatrices, ElementOperators, curl_tensor, vorticity_curl_tensor,
    srt_tensor, div_srt_tensor, compute_kle_matrices, compute_operators,
)
