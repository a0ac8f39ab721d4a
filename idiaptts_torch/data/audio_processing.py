"""The reference-named ``AudioProcessing`` facade: the port of
``idiaptts_tpu/data/audio_processing.py``.

Every static method of the JAX package's class exists under the same
name and delegates to the port's ops (``ops.mcep``, ``ops.stft``,
``ops.world``, ``ops.audio_io``).  Inputs and outputs are numpy arrays;
the methods that compute on tensors take a ``device`` (``"cuda"``
unless the caller passes ``"cpu"``).
"""

import logging

import numpy as np
import torch

from idiaptts_torch.ops import audio_io
from idiaptts_torch.ops import mcep as mcep_ops
from idiaptts_torch.ops import stft as stft_ops
from idiaptts_torch.ops.dispatch import resolve_device


def _tensor(x, device):
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=resolve_device(device))


class AudioProcessing:
    """Static spectral coding and decoding helpers."""

    # -- constants of a sample rate ---------------------------------------
    @staticmethod
    def fs_to_mgc_alpha(fs):
        """All-pass warping coefficient of a sample rate."""
        return mcep_ops.fs_to_mgc_alpha(fs)

    @staticmethod
    def fs_to_frame_length(fs):
        """CheapTrick FFT size of a sample rate."""
        return mcep_ops.fs_to_frame_length(fs)

    @staticmethod
    def fs_to_num_bap(fs):
        """Number of coded band aperiodicities."""
        from idiaptts_torch.ops.world.d4c import get_num_aperiodicities
        return get_num_aperiodicities(fs)

    # -- IO and framing --------------------------------------------------
    @staticmethod
    def get_raw(audio_name, preemphasis=0.0):
        """(raw float32, fs) of a wav file, optionally pre-emphasised."""
        return audio_io.get_raw(audio_name, preemphasis)

    @staticmethod
    def framing(raw, frame_length, hop_length):
        """(num_frames, frame_length) frames without centring."""
        return stft_ops.frame_signal(
            torch.as_tensor(np.asarray(raw, np.float32)), int(frame_length),
            int(hop_length), center=False).numpy()

    @staticmethod
    def preemphasis(raw, coefficient=0.97):
        return audio_io.apply_preemphasis(raw, coefficient)

    @staticmethod
    def depreemphasis(raw, coefficient=0.97):
        """Inverse pre-emphasis IIR."""
        return audio_io.depreemphasis(raw, coefficient)

    # -- analysis ----------------------------------------------------------
    @staticmethod
    def extract_mcep(amp_sp, num_coded_sps, mgc_alpha, device="cuda"):
        """Amplitude spectrum -> mel-cepstrum (the ``pysptk.mcep``
        itype=3 role)."""
        with torch.inference_mode():
            return mcep_ops.amp_sp_to_mcep(
                _tensor(amp_sp, device), num_coded_sps - 1,
                mgc_alpha).cpu().numpy()

    @staticmethod
    def extract_mgc(amp_sp, num_coded_sps=60, fs=None, mgc_alpha=None,
                    mgc_gamma=None, device="cuda"):
        """Mel-generalised cepstrum, approximated (gamma = 0) by the
        mel-cepstrum."""
        if mgc_alpha is None:
            mgc_alpha = mcep_ops.fs_to_mgc_alpha(fs)
        return AudioProcessing.extract_mcep(amp_sp, num_coded_sps,
                                            mgc_alpha, device=device)

    @staticmethod
    def librosa_extract_amp_sp(raw, fs, n_fft=None, hop_size_ms=5,
                               win_length=None, center=True,
                               device="cuda"):
        """STFT magnitude with librosa's conventions, divided by the
        square root of the bin count."""
        if n_fft is None:
            n_fft = mcep_ops.fs_to_frame_length(fs)
        hop = int(fs * hop_size_ms / 1000.0)
        with torch.inference_mode():
            amp = stft_ops.amp_spectrum(_tensor(raw, device), n_fft, hop,
                                        win_length, center=center)
            return amp.cpu().numpy() / np.sqrt(amp.shape[1])

    @staticmethod
    def extract_mfbanks(raw=None, fs=16000, amp_sp=None, n_fft=None,
                        hop_size_ms=5, num_coded_sps=80, device="cuda"):
        """Linear amplitude-mel features (``librosa.melspectrogram
        (S=amp_sp)``), not the log-power coding of WorldFeatLabelGen."""
        if amp_sp is None:
            amp_sp = AudioProcessing.librosa_extract_amp_sp(
                raw, fs, n_fft, hop_size_ms, device=device)
        if num_coded_sps == -1:
            return np.asarray(amp_sp, np.float32)
        fbank = stft_ops.mel_filterbank(
            fs, (amp_sp.shape[1] - 1) * 2, n_mels=num_coded_sps)
        return (np.asarray(amp_sp, np.float32)
                @ fbank.T).astype(np.float32)

    # -- decoding ----------------------------------------------------------
    @staticmethod
    def mcep_to_amp_sp(coded_sp, fs, alpha=None, device="cuda"):
        """Mel-cepstrum -> amplitude spectrum."""
        from idiaptts_torch.data.world_feat import WorldFeatLabelGen
        return WorldFeatLabelGen.mcep_to_amp_sp(coded_sp, fs, alpha=alpha,
                                                device=device)

    @staticmethod
    def mgc_to_amp_sp(coded_sp, fs, alpha=None, gamma=None, n_fft=None,
                      device="cuda"):
        """Mel-generalised cepstrum (decoded as a mel-cepstrum) ->
        amplitude spectrum."""
        from idiaptts_torch.data.world_feat import WorldFeatLabelGen
        num_bins = None if n_fft is None else n_fft // 2 + 1
        return WorldFeatLabelGen.mcep_to_amp_sp(coded_sp, fs, alpha=alpha,
                                                num_bins=num_bins,
                                                device=device)

    @staticmethod
    def mfbanks_to_amp_sp(coded_sp, fs, n_fft=None, device="cuda"):
        """NNLS mel inversion of the linear amplitude-mel coding of
        :meth:`extract_mfbanks` (the solver does not care about the
        scale, so it runs on the amplitudes)."""
        if n_fft is None:
            n_fft = mcep_ops.fs_to_frame_length(fs)
        with torch.inference_mode():
            return stft_ops.mel_power_to_power_sp(
                _tensor(coded_sp, device), int(fs),
                int(n_fft)).cpu().numpy()

    @staticmethod
    def decode_sp(coded_sp, sp_type="mcep", fs=None, alpha=None,
                  mgc_gamma=None, n_fft=None, post_filtering=False,
                  device="cuda"):
        """Coded-spectrum decode.  "mfbanks" inverts this facade's
        linear amplitude-mel coding, not WorldFeatLabelGen's log-power
        one."""
        if sp_type == "mfbanks":
            if post_filtering:
                logging.warning("Post-filtering only implemented for "
                                "cepstrum features.")
            return AudioProcessing.mfbanks_to_amp_sp(coded_sp, fs,
                                                     n_fft=n_fft,
                                                     device=device)
        from idiaptts_torch.data.world_feat import WorldFeatLabelGen
        return WorldFeatLabelGen.decode_sp(
            coded_sp, sp_type=sp_type, fs=fs, alpha=alpha, n_fft=n_fft,
            post_filtering=post_filtering, device=device)

    @staticmethod
    def amp_sp_to_raw(amp_sp, fs, hop_size_ms=5, preemphasis=0.97,
                      num_iters=60, angles=None, device="cuda"):
        """Griffin-Lim reconstruction, then de-emphasis.  The initial
        phases come from a generator seeded with 0 unless ``angles``
        gives them."""
        device = resolve_device(device)
        n_fft = (amp_sp.shape[1] - 1) * 2
        generator = None
        if angles is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        with torch.inference_mode():
            amp = _tensor(amp_sp, device) * np.sqrt(amp_sp.shape[1])
            raw = stft_ops.griffin_lim(
                amp, n_fft, int(fs * hop_size_ms / 1000.0),
                num_iters=num_iters, generator=generator,
                angles=angles).cpu().numpy()
        return AudioProcessing.depreemphasis(raw, preemphasis)

    # -- scales ------------------------------------------------------------
    @staticmethod
    def amp_to_db(amp):
        return stft_ops.amp_to_db(torch.as_tensor(
            np.asarray(amp, np.float32))).numpy()

    @staticmethod
    def db_to_amp(db):
        return stft_ops.db_to_amp(torch.as_tensor(
            np.asarray(db, np.float32))).numpy()
