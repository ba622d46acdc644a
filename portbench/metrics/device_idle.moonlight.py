"""device_idle.moonlight: the device's idle share of the training window
(``readers.device_idle``)."""

from portbench.readers import device_idle as read  # noqa: F401
