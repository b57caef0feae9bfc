"""The benchmark of the PyTorch port ``channelestimationtransformer_torch``
on an NVIDIA H100: ``python3 -m portbench.run --workload <cell> ...``
(``run.py``). Cells, configurations, traffic mixes, limits and metric
readers are files found by name (``manifest.py``)."""
