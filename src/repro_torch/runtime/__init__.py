"""Runtimes of the port: serving (``runtime/server.py``) and training
(``runtime/trainer.py``)."""
