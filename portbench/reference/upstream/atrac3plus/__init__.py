"""A NumPy model of the upstream ATRAC3+ encoder (dcherednik/atracdenc,
``-e atrac3plus``), frame at a time in float32: ``encoder.py`` (the PQF,
the MDCT, the scaler, the VLC choice, the numQU shrink and the frame loop
with its look-ahead), ``gha.py`` (the GHA tonal model) and the writer and
parser ``frame.py``.  It is written from the JAX package's ATRAC3+ modules
(``atracdenc_tpu/models/atrac3p/``); ``frame.py``, ``tables.py`` and
``format_data.npz`` are copies, the parser's bit reader and VLC lookup made
faster.  Nothing of it comes from the program.

Where it departs from upstream, as the JAX package does (upstream's libgha,
the sinusoid estimator, is absent from its tree):

  * waves are estimated by greedy rounds on the 2048-point DFT grid of each
    128-sample subband frame (the peak bin gives frequency, amplitude and
    phase), not by libgha's estimator and Newton refine;
  * at most ``MAX_WAVES`` = 8 rounds a subband, where the wire allows 15;
  * a wave stays only if it removes at least 10% of the lane's energy;
  * the 48-wave limit of a frame keeps the strongest waves, where upstream's
    ApplyFilter gives up on the frame;
  * the wideband GHA strategy (mask bit 8) is not modelled.
"""
