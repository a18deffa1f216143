from pynama_tpu_torch.ibm.bodies import (BodiesContainer, Circle, Line,
                                         OpenBox, four_grid, three_grid,
                                         linear)

__all__ = ["BodiesContainer", "Circle", "Line", "OpenBox",
           "four_grid", "three_grid", "linear"]
