"""Compressed-stream containers (AEA, OMA, RIFF/AT3, RealMedia, RAW)."""
