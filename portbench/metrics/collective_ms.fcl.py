"""collective_ms.fcl: device ms a fcl call outside the product kernels
(``readers.collective_ms``)."""

from portbench.readers import collective_ms as read  # noqa: F401
