"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell once (``python3 portbench/run.py --workload <name> ...``).

Everything of one configuration, traffic mix, metric, family reference or
family count sits in a file of its own that the harness finds by the name
``BENCHMARK.json`` gives it. Nothing here imports ``jax`` or ``repro``."""
