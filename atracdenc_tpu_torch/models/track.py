"""One track loop for every codec: a track is chunks of the codec's batched
chunk call.

Each codec's ``encode_track`` hands this loop its chunk call (pcm [C, k *
n] on the device, the previous chunk's carry or None, the next chunk's
first frame or None -> (planes, carry)), and the names of its planes that
have no channel axis (``PER_FRAME`` in its encoder module: [F, ...], every
other plane [C, F, ...]; a nested plane is named ``outer.inner``).  A track
short enough for one chunk is that chunk with no carry and no lookahead:
the same call, so chunked and one-chunk tracks run the same code.
"""
import numpy as np

from atracdenc_tpu_torch import runtime, trace


def frame_axis(name, per_frame, lead=0):
    """The frame axis of plane ``name`` behind ``lead`` stream axes."""
    return lead + (0 if name in per_frame else 1)


def join(blocks, per_frame, lead=0, prefix=""):
    """Blocks of planes ({name: array}, nested dicts allowed) joined on each
    plane's frame axis, in order."""
    out = {}
    for k, v in blocks[0].items():
        if isinstance(v, dict):
            out[k] = join([b[k] for b in blocks], per_frame, lead,
                          f"{prefix}{k}.")
        else:
            out[k] = np.concatenate([b[k] for b in blocks], axis=frame_axis(
                prefix + k, per_frame, lead))
    return out


def encode_track(chunk, pcm, frame_len, chunk_frames, per_frame, span,
                 progress=None, device=None):
    """[C, T] PCM -> the planes of ``chunk`` over the whole track, as numpy.

    Pads the track to whole frames of ``frame_len`` samples and cuts it into
    chunks of ``chunk_frames`` frames (the whole track when it is 0 or None,
    or at least the track's length); each chunk gets the carry of the one
    before and the first frame of the one after, runs under a ``span``
    span and is read back.  device: "cuda" (the default) or an explicit
    "cpu".  progress: optional callback(percent) after each chunk."""
    dev = runtime.device(device)
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    pad = (-pcm.shape[1]) % frame_len
    if pad:
        pcm = np.pad(pcm, ((0, 0), (0, pad)))
    f_total = pcm.shape[1] // frame_len
    step = chunk_frames or f_total
    state, outs = None, []
    for a in range(0, f_total, step):
        b = min(a + step, f_total)
        with trace.span(span):
            nxt = (runtime.to_torch(pcm[:, b * frame_len:(b + 1) * frame_len],
                                    dev) if b < f_total else None)
            planes, state = chunk(runtime.to_torch(
                pcm[:, a * frame_len:b * frame_len], dev), state, nxt)
            outs.append(runtime.state_to_numpy(planes))
        if progress is not None:
            progress(int(b * 100 / f_total))
    return join(outs, per_frame)
