"""portbench: the benchmark of hpfw_tpu_torch on an NVIDIA H100.

One run measures one cell (a deployment under one traffic mix) and prints one
JSON line; see run.py. Everything a cell, configuration, traffic kind,
per-layer metric or kernel count needs is a file of its own under this
folder, found by its name in BENCHMARK.json. Nothing here imports jax,
jaxlib or hpfw_tpu; reference/ imports no hpfw_tpu_torch either.
"""
