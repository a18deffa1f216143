from pynama_tpu_torch.io.viewer import Paraviewer
from pynama_tpu_torch.io.xdmf import XdmfWriter
from pynama_tpu_torch.io.checkpoint import save_checkpoint, load_checkpoint

__all__ = ["Paraviewer", "XdmfWriter", "save_checkpoint", "load_checkpoint"]
