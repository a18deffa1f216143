from pynama_tpu_torch.cases.problem import Problem
