"""The benchmark's CPU tests import the port from src/, as bench/run.py does."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = str(ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
