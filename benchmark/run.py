"""Runs one cell of the benchmark once and prints its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA card(s) the cell
asks for; `harness.py` says what a run does.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

if __name__ == "__main__":
    from harness import main
    sys.exit(main(sys.argv[1:]))
