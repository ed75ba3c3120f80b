"""The benchmark's tests: the program (``repro_torch``) is imported from
the checkout's ``src``, as ``portbench/run.py`` does."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
