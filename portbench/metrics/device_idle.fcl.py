"""device_idle.fcl: the device's idle share of the fcl cells' window
(``readers.device_idle``)."""

from portbench.readers import device_idle as read  # noqa: F401
