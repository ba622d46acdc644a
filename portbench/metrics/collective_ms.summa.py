"""collective_ms.summa: device ms a summa call outside the product kernels
(``readers.collective_ms``)."""

from portbench.readers import collective_ms as read  # noqa: F401
