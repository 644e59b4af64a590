"""The benchmark of the PyTorch / CUDA port ``atracdenc_tpu_torch`` (see
README.md and ``python3 -m portbench.run --help``)."""
