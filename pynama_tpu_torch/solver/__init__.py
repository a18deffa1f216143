from pynama_tpu_torch.solver.cg import pcg
from pynama_tpu_torch.solver.timestep import BS5, adaptive_solve
