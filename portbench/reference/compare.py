"""The numbers that decide ``correct``, from the program's rows and the
upstream encoder's.

* ``frames_differ``: the share of compared rows (ATRAC3 stereo frames,
  ATRAC1 sound units) whose bytes differ from the reference's.  Rows the
  program did not deliver count as differing.
* ``worst_frame_err``: over the differing rows, the largest error energy
  of the row's dequantised spectrum against the reference row's, relative
  to the reference row's energy.  A knife-edge decision (one mantissa, one
  scale factor) moves it little; a frame coded from the wrong state, or
  bytes altered after the encoder, move it a lot.  A row that does not
  parse, and rows not delivered, read ``BROKEN``.
* ``mean_frame_err``: that relative error energy averaged over every
  compared row (equal rows count 0).

Each distinct pair of differing rows is dequantised once, however often
the window delivered it (every generation codes the same PCM).
"""
import numpy as np
import torch

EPS = 1e-9            # energy floor of the reference row (silent rows)
BROKEN = 1e9


class Tally:
    """Accumulates rows compared, rows differing and the differing pairs."""

    def __init__(self):
        self.rows = 0
        self.differ = 0
        self.pairs = {}               # (prog bytes, ref bytes) -> count
        self.lost_units = 0           # deliveries the program did not make

    def add(self, prog, ref):
        """prog, ref: uint8 [n, row_bytes] tensors (any device) or arrays."""
        prog = torch.as_tensor(prog).cpu()
        ref = torch.as_tensor(ref).cpu()
        if prog.shape != ref.shape:
            self.lost(ref.shape[0])
            return
        mask = (prog != ref).any(dim=-1)
        self.rows += ref.shape[0]
        n = int(mask.sum())
        self.differ += n
        for p, r in zip(prog[mask].numpy(), ref[mask].numpy()):
            key = (p.tobytes(), r.tobytes())
            self.pairs[key] = self.pairs.get(key, 0) + 1

    def lost(self, n_rows):
        """``n_rows`` rows that the program did not deliver as it should."""
        self.rows += n_rows
        self.differ += n_rows
        self.lost_units += 1

    def numbers(self, spectra):
        """-> {"frames_differ", "worst_frame_err", "mean_frame_err"}."""
        share = self.differ / max(self.rows, 1)
        if self.lost_units:
            return {"frames_differ": share, "worst_frame_err": BROKEN,
                    "mean_frame_err": BROKEN}
        if not self.pairs:
            return {"frames_differ": share, "worst_frame_err": 0.0,
                    "mean_frame_err": 0.0}
        keys = list(self.pairs)
        counts = np.asarray([self.pairs[k] for k in keys], np.float64)
        prog = np.stack([np.frombuffer(p, np.uint8) for p, _ in keys])
        ref = np.stack([np.frombuffer(r, np.uint8) for _, r in keys])
        errs = row_errs(spectra, prog, ref)
        return {"frames_differ": share, "worst_frame_err": float(errs.max()),
                "mean_frame_err": float(errs @ counts) / max(self.rows, 1)}


def row_errs(spectra, prog, ref):
    """Relative error energies of rows [n, row_bytes]: all rows in one
    call, or one by one where a row does not parse."""
    try:
        sp = spectra(prog)
    except (ValueError, IndexError, KeyError):
        return np.asarray([row_err(spectra, p, r) for p, r in zip(prog, ref)])
    sr = spectra(ref).astype(np.float64)
    axes = tuple(range(1, sr.ndim))
    return (np.sum((sp.astype(np.float64) - sr) ** 2, axis=axes)
            / (np.sum(sr ** 2, axis=axes) + EPS))


def row_err(spectra, prog_row, ref_row):
    """Relative error energy of one row's dequantised spectrum."""
    try:
        sp = spectra(prog_row[None])
    except (ValueError, IndexError, KeyError):
        return BROKEN
    sr = spectra(ref_row[None])
    return float(np.sum((sp.astype(np.float64) - sr) ** 2)
                 / (np.sum(sr.astype(np.float64) ** 2) + EPS))
