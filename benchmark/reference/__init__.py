"""The plain references the benchmark judges the measured solver by, plain
numpy and PyTorch, no code of the measured package: the shared set-up
(`setup.py`) and one module per kind of case, which a configuration names
under "reference" (`cavity.py`: box cavities with constant walls)."""
