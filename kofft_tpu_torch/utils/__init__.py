"""Host helpers of the port."""

from .transfer import asnumpy  # noqa: F401
