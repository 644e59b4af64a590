"""A NumPy model of the upstream ATRAC1 and ATRAC3 encoders
(dcherednik/atracdenc), bit for bit: the JAX package's QA path
(``atracdenc_tpu/models/atrac1/{exact_enc,exact_synth,tables,frame}.py``,
``atracdenc_tpu/models/atrac3/{exact_enc,exact_gain,tables,frame}.py``,
``atracdenc_tpu/utils/bitpack.py``), copied with the imports pointed here;
left out are the native packer's dispatch, one unused JAX-backed table and
the ATRAC1 decoder's synthesis.
The files keep the upstream source anchors that each step replays."""
