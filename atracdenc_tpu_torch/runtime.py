"""Device selection, the f32 policy and numpy <-> torch conversion.

The JAX package runs every matmul at ``Precision.HIGHEST`` (plain f32).  On
CUDA, PyTorch would route f32 matmuls and cuDNN convolutions through TF32
(about three decimal digits) if allowed, so both switches are turned off
here, at import, for the whole process.  Every module of the port imports
this one first.

``to_numpy`` and ``host_bool`` of a device tensor, and ``to_torch`` and
``from_host`` to a device, are where the program blocks the host on the
card (a copy from pageable host memory ends in a stream synchronisation);
each counts ``host_sync`` in ``trace``.
"""
import numpy as np
import torch

from atracdenc_tpu_torch import trace

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# dtype canonicalisation of the JAX package (x64 off): int64 -> int32,
# float64 -> float32, so the port's planes carry the JAX planes' dtypes
_CANON = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


def device(name=None) -> torch.device:
    """The compute device: CUDA unless ``name`` asks for the CPU.

    There is no silent fallback: asking for CUDA on a machine without it
    raises.  The CPU is for tests and runs each kernel's plain version."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is false; "
            "pass device='cpu' explicitly to run the plain versions")
    return dev


def canonical(a) -> np.ndarray:
    a = np.asarray(a)
    tgt = _CANON.get(a.dtype)
    return a.astype(tgt) if tgt is not None else a


def to_torch(a, dev) -> torch.Tensor:
    """numpy (or scalar) -> tensor on ``dev`` with JAX's canonical dtypes."""
    a = canonical(a)              # keeps 0-d (ascontiguousarray makes 1-d)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")
    if torch.device(dev).type != "cpu":
        trace.count("host_sync")
    return torch.from_numpy(a).to(dev)


def from_host(data, dev, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=dev)``, counting a
    ``host_sync`` when host data goes to a device that is not the CPU."""
    kind = torch.device(dev).type
    if kind != "cpu" and not (isinstance(data, torch.Tensor)
                              and data.device.type == kind):
        trace.count("host_sync")
    return torch.as_tensor(data, dtype=dtype, device=dev)


def host_bool(t) -> bool:
    """``bool(t)`` of a one-element tensor, counting a ``host_sync`` when it
    is not on the CPU."""
    if t.device.type != "cpu":
        trace.count("host_sync")
    return bool(t)


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.device.type != "cpu":
            trace.count("host_sync")
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def state_from_numpy(state, dev):
    """A tree (nested dicts) of numpy arrays to tensors on ``dev``: a chunk
    carry — e.g. a JAX encoder's state after ``jax.device_get``, in either
    encoder's layout: ATRAC3 ``{gain: {...}, mdct_prev, next_overlap,
    loudness, pcm_tail}`` (``models/atrac3/encoder.init_state``) or ATRAC1
    ``{pcm_tail, loud}`` (``models/atrac1/encoder.encode_frames_chunk``) —
    or a codec's planes."""
    return _map(state, lambda a: to_torch(a, dev))


def state_to_numpy(state):
    """``state_from_numpy``'s inverse: a tree of tensors to numpy."""
    return _map(state, to_numpy)
