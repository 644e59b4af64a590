"""Device selection, the f32 policy and numpy <-> torch conversion.

The JAX package runs every matmul at ``Precision.HIGHEST`` (plain f32).  On
CUDA, PyTorch would route f32 matmuls and cuDNN convolutions through TF32
(about three decimal digits) if allowed, so both switches are turned off
here, at import, for the whole process.  Every module of the port imports
this one first.
"""
import numpy as np
import torch

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
    a = np.ascontiguousarray(canonical(a))
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def state_from_numpy(state, dev):
    """Chunk carry (``encoder.init_state`` layout: gain, mdct_prev,
    next_overlap, loudness, pcm_tail) from numpy arrays — e.g. the JAX
    encoder's state after ``jax.device_get`` — to tensors on ``dev``."""
    return _map(state, lambda a: to_torch(a, dev))


def state_to_numpy(state):
    return _map(state, to_numpy)
