"""B1's byte bound (``counts/knn_bytes.py``) over its device time (%)."""

from portbench.readers import knn_roofline_pct as read  # noqa: F401
