"""Codec adapters: how the benchmark calls the program for one codec.

A configuration file names its adapter (``"codec"``); the adapter module
``portbench/codecs/<codec>.py`` holds a ``Codec`` class with the program's
batched call path (``encode_chunk``) and the program modules whose
functions the per-layer metrics wrap (``MODULES``).
``portbench/reference/<codec>.py`` codes the same PCM with the upstream
encoder's model (``encode_rows``) and dequantises rows (``spectra``).
"""
