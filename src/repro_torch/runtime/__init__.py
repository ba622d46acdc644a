"""Serving runtime of the port (``runtime/server.py``)."""
