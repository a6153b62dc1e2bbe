"""Median wall ms of a scan (the harness's span around each
``Model.predict`` call of the untraced window, confidences on the host)."""

from portbench.readers import median_ms as read  # noqa: F401
