"""The ATRAC3 encoder's batched call path: ``encode_frames_chunk`` and the
device packer ``pack_device_batch``, as a library user batches tracks."""
from atracdenc_tpu_torch.models.atrac3 import device_pack, encoder

SAMPLES_PER_FRAME = 1024
CHANNELS_PER_ROW = 2        # one output row is one stereo frame
MODULES = {"encoder": "atracdenc_tpu_torch.models.atrac3.encoder",
           "gain": "atracdenc_tpu_torch.models.atrac3.gain",
           "device_pack": "atracdenc_tpu_torch.models.atrac3.device_pack"}


class Codec:
    def __init__(self, cfg):
        self.frame_bytes = cfg["frame_bytes"]
        self.js = cfg["joint_stereo"]
        self.opts = dict(frame_bytes=self.frame_bytes, js=self.js,
                         no_gain_control=not cfg["gain_control"],
                         no_tonal=not cfg["tonal_components"],
                         bfu_idx_const=cfg["bfu_idx_const"])
        self.row_bytes = self.frame_bytes

    def encode_chunk(self, pcm, state, next_pcm):
        """pcm f32 [S, 2, T] on the card, ``state`` None at a track's start,
        ``next_pcm`` [S, 2, 1024] (None at its end) -> (rows uint8 [S, F,
        frame_bytes] on the card, state)."""
        planes, state = encoder.encode_frames_chunk(pcm, state, next_pcm,
                                                    **self.opts)
        return device_pack.pack_device_batch(planes, self.frame_bytes,
                                             self.js), state
