from pynama_tpu_torch.mesh.box import BoxMesh
