"""Runtimes of the port: serving (``runtime/server.py``), training with
its data-parallel step (``runtime/trainer.py``) and elastic re-meshing
(``runtime/elastic.py``)."""
