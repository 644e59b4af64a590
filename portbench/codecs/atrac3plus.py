"""The ATRAC3+ encoder's batched call path: ``encode_chunk_bytes``, the
batched chunk call (``encode_chunk_device``: the encoder with its carry,
on the card) and the device packer ``pack_device``."""
from atracdenc_tpu_torch.models.atrac3p.encoder import encode_chunk_bytes

SAMPLES_PER_FRAME = 2048
CHANNELS_PER_ROW = 2        # one output row is one stereo frame
MODULES = {"encoder": "atracdenc_tpu_torch.models.atrac3p.encoder",
           "gha": "atracdenc_tpu_torch.models.atrac3p.gha",
           "device_pack": "atracdenc_tpu_torch.models.atrac3p.device_pack"}


class Codec:
    def __init__(self, cfg):
        self.opts = dict(gha_mask=cfg["gha_mask"], wb_refine=cfg["wb_refine"])
        self.row_bytes = cfg["frame_bytes"]

    def encode_chunk(self, pcm, state, next_head):
        """pcm f32 [S, 2, T] on the card, ``state`` None at a track's start,
        ``next_head`` [S, 2, 2048] (None at its end) -> (rows uint8 [S, F,
        2048] on the card, state)."""
        return encode_chunk_bytes(pcm, state, next_head, **self.opts)
