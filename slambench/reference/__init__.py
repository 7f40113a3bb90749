"""The plain reference the benchmark holds each run's outputs against.

Plain PyTorch and NumPy, written for the benchmark: it imports nothing of
the program and takes nothing the program made but the outputs it judges
(and, where a stage can only follow the program's own state, that state;
see judge.py). Each function takes `rnd`, a rounding applied to the
operands of its arithmetic: `precision.exact` for the reference, a lower
precision for its control.
"""
