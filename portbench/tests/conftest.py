import os
import sys

# the benchmark is run from the repository's root: make its packages importable
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
