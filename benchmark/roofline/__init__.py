"""Roofline time of a call, from the problem's shapes alone.

A call's roofline is the least time an H100 could take for it: the larger
of its field products over the card's integer multiply rate and its bytes
over the card's memory bandwidth. Both are counted from what the problem
needs (``work.py``), never from how the program does it, so a redesign of
a kernel (another window, signed digits, another layout) leaves them as
they are; ``peaks.py`` holds the card's published rates.
"""

from .peaks import HBM_BYTES_PER_S, INT_MULS_PER_FIELD_PRODUCT, INT_MULS_PER_S
from .work import Work, msm_work, ntt_work, roofline_s

__all__ = [
    "HBM_BYTES_PER_S",
    "INT_MULS_PER_FIELD_PRODUCT",
    "INT_MULS_PER_S",
    "Work",
    "msm_work",
    "ntt_work",
    "roofline_s",
]
