"""device_idle.ring: the device's idle share of the ring-schedule cell's
window (``readers.device_idle``)."""

from portbench.readers import device_idle as read  # noqa: F401
