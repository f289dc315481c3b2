"""The benchmark's own tests: ``python -m pytest h100_bench/tests -q`` from
the repository's root. They run on the CPU at small sizes; the one marked
``gpu`` runs a cell on the card and skips inside the test without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
