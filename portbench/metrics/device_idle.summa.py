"""device_idle.summa: the device's idle share of the summa cells' window
(``readers.device_idle``)."""

from portbench.readers import device_idle as read  # noqa: F401
