"""The port's measurement tools, one per JAX package tool of the same file
name (tools/*.py), each a module with a main(argv):

    python -m alignq_tpu_torch.tools.<name> [--smoke] [--device cpu]

Each prints {"card": ...} (utils/launches.py card_line) first, then one
JSON line per row under the JAX tool's row names. Without --device it
runs on the CUDA card and raises where there is none; --smoke runs the
cheapest sizes, a check that the tool runs, not a measurement.
"""
