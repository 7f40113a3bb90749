"""Mean milliseconds of LidarFrontend.process_scan, between two
synchronisations of the card (traced run)."""
import numpy as np


def read(rec):
    xs = rec["spans"]["frontend_ms"]
    return float(np.mean(xs)) if xs else None
