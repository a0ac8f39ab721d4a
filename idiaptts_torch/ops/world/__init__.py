"""WORLD-style vocoder analysis and synthesis in PyTorch: the port of
``idiaptts_tpu/ops/world``.

* :mod:`f0`         - F0 tracking (NCCF candidates, Viterbi, IF
                      refinement; the four-interval voicing on the host).
* :mod:`cheaptrick` - pitch-adaptive spectral envelope.
* :mod:`d4c`        - band aperiodicity, its coding and decoding.
* :mod:`extract`    - the whole analysis of one waveform in one pass.
* :mod:`synthesis`  - phase-coherent harmonic + shaped-noise synthesis.
"""

from idiaptts_torch.ops.world.f0 import extract_f0  # noqa: F401
from idiaptts_torch.ops.world.cheaptrick import cheaptrick  # noqa: F401
from idiaptts_torch.ops.world.d4c import d4c_band_aperiodicity  # noqa: F401
from idiaptts_torch.ops.world.synthesis import world_synthesis  # noqa: F401
