from pynama_tpu_torch.bc.conditions import BoundaryConditions, SideBC
