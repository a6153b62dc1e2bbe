"""Device ms a scan of the row-gather kernels (index_select, advanced
indexing, gather)."""

from portbench.readers import gather_ms_per_call as read  # noqa: F401
