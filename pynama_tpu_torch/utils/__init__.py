from pynama_tpu_torch.utils.timer import Timer

__all__ = ["Timer"]
