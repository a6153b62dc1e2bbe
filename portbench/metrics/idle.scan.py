"""Share (%) of the traced window in which no device activity ran."""

from portbench.readers import idle_pct as read  # noqa: F401
