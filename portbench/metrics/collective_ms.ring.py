"""collective_ms.ring: device ms a SUMMA call under the ring schedule
outside the product kernels (``readers.collective_ms``)."""

from portbench.readers import collective_ms as read  # noqa: F401
