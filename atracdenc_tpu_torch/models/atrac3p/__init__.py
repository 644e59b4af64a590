"""ATRAC3+ codec on PyTorch: encoder with the GHA tonal model, device
packer and QA decoder (port of ``atracdenc_tpu/models/atrac3p``)."""
