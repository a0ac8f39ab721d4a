"""Band-aperiodicity decode: the port of
``idiaptts_tpu/ops/world/d4c.py:decode_aperiodicity``.  The D4C analysis
(feature extraction) is not on the serving path and is not ported yet.
"""

import numpy as np
import torch

_AP_FLOOR = 1e-9


def decode_aperiodicity(bap, num_bins, fs):
    """Coded bap (..., num_bands) -> aperiodicity (..., num_bins) by
    piecewise-linear interpolation of the log ratio over band anchors
    (pyworld.decode_aperiodicity role).  As in WORLD, the 0 Hz anchor is
    pinned at the aperiodicity floor and the Nyquist anchor holds the
    last band's value."""
    if bap.dim() == 1:
        bap = bap[None]
    num_bands = bap.shape[-1]
    log_floor = float(np.log(_AP_FLOOR))
    log_ratio = torch.clamp(bap, log_floor, 0.0)
    anchors_f = np.concatenate([[0.0], 3000.0 * (np.arange(num_bands) + 1.0),
                                [fs / 2.0]]).astype(np.float32)
    anchors_v = torch.cat([
        torch.full(bap.shape[:-1] + (1,), log_floor, dtype=bap.dtype,
                   device=bap.device),
        log_ratio, log_ratio[..., -1:]], dim=-1)
    # The anchor grid is shared, so the segment of each bin and its
    # interpolation weight are host constants.
    freqs = np.linspace(0.0, fs / 2.0, num_bins, dtype=np.float32)
    seg = np.clip(np.searchsorted(anchors_f, freqs, side="right") - 1,
                  0, num_bands)
    f_lo = anchors_f[seg]
    f_hi = anchors_f[seg + 1]
    w = np.where(f_hi > f_lo,
                 (freqs - f_lo) / np.maximum(f_hi - f_lo, 1e-9), 0.0)
    w = torch.as_tensor(w.astype(np.float32), device=bap.device)
    seg_t = torch.as_tensor(seg, device=bap.device)
    v_lo = anchors_v[..., seg_t]
    v_hi = anchors_v[..., seg_t + 1]
    ap_log = v_lo * (1.0 - w) + v_hi * w
    return torch.clamp(torch.exp(ap_log), _AP_FLOOR, 1.0)
