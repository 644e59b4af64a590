"""Gain-control YAML debug stream (the reference's --yaml-log).

Emits one YAML document per frame describing the per-band gain decisions
(reference format: src/yaml_log.h:19-57, emission sites threaded through
src/atrac3denc.cpp:306-570).  The whole-track encoder recomputes the gain
intermediates in one batched debug pass and the host serializes them.
"""
import numpy as np


def write(fp, planes, dbg):
    """planes: encoder output dict; dbg: gain.gain_control(debug=True) dict."""
    hfr = np.asarray(dbg["high_freq_ratio"])
    hov = np.asarray(dbg["hpf_overlap_ratio"])
    dms = np.asarray(dbg["dynamic_min_score"])
    gain = np.asarray(dbg["gain"])
    target = np.asarray(dbg["target"])
    prev_target = np.asarray(dbg["prev_target"])
    max_gain = np.asarray(dbg["max_gain"])
    levels = np.asarray(planes["gain_levels"])
    locs = np.asarray(planes["gain_locs"])
    npts = np.asarray(planes["gain_npoints"])
    c, f = hfr.shape[:2]

    for fi in range(f):
        fp.write("---\nframe: %d\ntime: %.3f  # seconds\nchannels:\n"
                 % (fi, fi * 1024 / 44100.0))
        for ch in range(c):
            fp.write("  - channel: %d\n    bands:\n" % ch)
            for b in range(4):
                fp.write("      - band: %d\n" % b)
                fp.write("        high_freq_ratio: %.4f\n" % hfr[ch, fi, b])
                if hfr[ch, fi, b] < 0.05:
                    fp.write("        skip: low_hfr\n")
                    continue
                fp.write("        hpf_overlap_ratio: %.4f\n" % hov[ch, fi, b])
                fp.write("        dynamic_min_score: %.4f\n" % dms[ch, fi, b])
                fp.write("        gain: [%s]  # 32 subframe RMS values\n"
                         % ", ".join("%.4f" % v for v in gain[ch, fi, b]))
                fp.write("        target: %.6f\n" % target[ch, fi, b])
                fp.write("        prev_target: %.6f\n"
                         % prev_target[ch, fi, b])
                fp.write("        max_gain: %.4f\n" % max_gain[ch, fi, b])
                fp.write("        curve_final:\n")
                for p in range(int(npts[ch, fi, b])):
                    fp.write("          - {level: %d, loc: %d}\n"
                             % (levels[ch, fi, b, p], locs[ch, fi, b, p]))
