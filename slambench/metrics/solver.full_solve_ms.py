"""Mean milliseconds of engine.solve_full between two synchronisations of
the card (traced run)."""
import numpy as np


def read(rec):
    xs = rec["spans"]["full_solve_ms"]
    return float(np.mean(xs)) if xs else None
