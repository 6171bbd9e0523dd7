"""Device: share of the traced window with no operation running."""
from portbench.readers import idle_pct as read  # noqa: F401
