"""The ATRAC1 encoder's batched call path: ``encode_frames_chunk``, the
per-stream merge of the planes (as ``parallel/mesh.py``'s column chain
merges them) and the device packer ``pack_device``."""
from atracdenc_tpu_torch.models.atrac1 import device_pack, encoder

SAMPLES_PER_FRAME = 512
CHANNELS_PER_ROW = 1        # one output row is one channel's sound unit
UNIT_BYTES = 212
PLANES = ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")
MODULES = {"encoder": "atracdenc_tpu_torch.models.atrac1.encoder",
           "psy": "atracdenc_tpu_torch.ops.psy",
           "bitalloc": "atracdenc_tpu_torch.models.atrac1.bitalloc"}


class Codec:
    def __init__(self, cfg):
        self.opts = dict(bfu_idx_const=cfg["bfu_idx_const"],
                         window_mode=cfg["window_mode"],
                         window_mask=cfg["window_mask"])
        self.row_bytes = UNIT_BYTES

    def encode_chunk(self, pcm, state, next_head):
        """pcm f32 [S, C, T] on the card, ``state`` None at a track's start,
        ``next_head`` [S, C, 512] (None at its end) -> (rows uint8 [S, F *
        C, 212] on the card, each stream's units in (frame, channel)
        order, state)."""
        s = pcm.shape[0]
        planes, state = encoder.encode_frames_chunk(pcm, state, next_head,
                                                    **self.opts)
        merged = {k: planes[k].transpose(1, 2).reshape(
            (-1,) + planes[k].shape[3:]) for k in PLANES}
        return device_pack.pack_device(merged).reshape(
            s, -1, UNIT_BYTES), state
