"""Median milliseconds of SlamNode.process_keyframe between two
synchronisations of the card, over the keyframes whose call ran no
periodic full solve (traced run)."""
import numpy as np


def read(rec):
    xs = [t for t, full in zip(rec["spans"]["step_ms"],
                               rec["spans"]["step_full_solve"]) if not full]
    return float(np.median(xs)) if xs else None
