from pynama_tpu_torch.engine.local_engine import (EngineOps, build_engine,
                                                  rhs_local, solve_kle_local,
                                                  apply_vorticity_bc,
                                                  apply_velocity_bc)

__all__ = ["EngineOps", "build_engine", "rhs_local", "solve_kle_local",
           "apply_vorticity_bc", "apply_velocity_bc"]
