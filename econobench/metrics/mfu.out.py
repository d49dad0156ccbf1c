"""``mfu.open`` in the cells where it should move ``out_tok_s``."""
from pathlib import Path

from econobench.harness import load_module

read = load_module(Path(__file__).with_name("mfu.open.py")).read
