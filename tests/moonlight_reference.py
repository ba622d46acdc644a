"""The plain reference of Moonlight-16B-A3B (DeepSeek-V3's architecture) in
training, plain ``torch`` in f32 with TF32 off, importing nothing of the
port and nothing of JAX.  The tests and the benchmark hold one copy of it,
``portbench/reference/moonlight.py``: this module is that file, loaded by
its path, so that ``import moonlight_reference`` gives the benchmark's
module itself (its functions, and its ``PIN_MARGIN`` as the functions read
it)."""

import importlib.util
import sys
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    __name__, Path(__file__).resolve().parents[1] / "portbench" / "reference" / "moonlight.py")
_module = importlib.util.module_from_spec(_spec)
sys.modules[__name__] = _module
_spec.loader.exec_module(_module)
