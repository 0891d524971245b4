"""The benchmark of bmh_tpu_torch, the PyTorch and CUDA codec.

One command runs one cell of BENCHMARK.json once:

    python3 -m bmhbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's inputs from the seed, loads and warms the program
(set-up), drives the program's API for the window, checks what the timed
calls produced against the plain reference (reference.py), and prints one
JSON line.  Everything that belongs to one configuration, traffic mix or
metric sits in a file of its own that the harness finds by name:
configs/<config>.json, traffic/<traffic>.json, generators/<kind>.py and
metrics/<metric>.py.
"""
