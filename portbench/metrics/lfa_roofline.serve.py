"""B2 and B3's least time (``counts/lfa_bound.py``) over their device time (%)."""

from portbench.readers import lfa_roofline_pct as read  # noqa: F401
