"""Median wall ms of a served batch (the harness's span around each
``Model.predict_mask`` call of the untraced window)."""

from portbench.readers import median_ms as read  # noqa: F401
