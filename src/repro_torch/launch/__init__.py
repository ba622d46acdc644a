"""Command-line entry points of the port (``launch/serve.py``,
``launch/train.py``) and the sharding policy of a mesh (``launch/steps.py:make_policy``)."""
