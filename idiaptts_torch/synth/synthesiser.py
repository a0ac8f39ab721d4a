"""Synthesiser: the port of ``idiaptts_tpu/synth/synthesiser.py``'s raw
and WaveNet backends.

``run_r9y9wavenet_mulaw_world_feats_synth`` takes WORLD frame features
per utterance, applies the optional Merlin post-filter to the coded
spectrum, upsamples the features to the sample rate and vocodes every
utterance in one padded batch through :class:`WaveNetVocoder` (one
sampler launch on the card), writing one wav file per utterance cut to
its length.  Not ported yet: ``run_world_synth``, Griffin-Lim and
``copy_synth`` (ROADMAP.md queue 1 item 9).
"""

import logging
import os

import numpy as np
import torch

from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.models.wavenet import WaveNetVocoder
from idiaptts_torch.ops import audio_io
from idiaptts_torch.ops import mcep as mcep_ops
from idiaptts_torch.ops.interpolation import sample_linearly

logger = logging.getLogger(__name__)


class Synthesiser:

    @staticmethod
    def _out_path(id_name, hparams, suffix=""):
        out_dir = hparams.get("synth_dir") or os.path.join(
            hparams.get("out_dir") or ".", "synth")
        os.makedirs(out_dir, exist_ok=True)
        ext = hparams.get("synth_ext", "wav")
        suffix += hparams.get("synth_file_suffix") or ""
        return os.path.join(out_dir, "{}{}.{}".format(id_name, suffix,
                                                      ext))

    @staticmethod
    def run_raw_synth(synth_output, hparams, epoch=None):
        """{id: waveform} -> wav files."""
        fs = hparams.get("synth_fs", 16000)
        paths = {}
        for id_name, raw in synth_output.items():
            path = Synthesiser._out_path(id_name, hparams)
            audio_io.raw_to_file(path, _norm_loudness(np.squeeze(raw)),
                                 fs)
            paths[id_name] = path
        return paths

    @staticmethod
    def raw_to_file(id_name, raw, hparams):
        path = Synthesiser._out_path(id_name, hparams)
        return audio_io.raw_to_file(path, _norm_loudness(raw),
                                    hparams.get("synth_fs", 16000))

    @staticmethod
    def run_wavenet_vocoder(synth_output, hparams, epoch=None):
        """{id: sample-rate conditioning (T, C)} -> wav files through the
        WaveNet checkpoint at ``hparams.synth_vocoder_path`` (added with
        ``hparams.add_hparams``), on ``hparams.device``.  All utterances
        are padded into one batch; each output is cut to its length."""
        vocoder = WaveNetVocoder.load(hparams.synth_vocoder_path, hparams)
        fs = hparams.get("synth_fs", 16000)
        ids = list(synth_output.keys())
        conds = [np.asarray(synth_output[i], np.float32) for i in ids]
        lengths = [len(c) for c in conds]
        t_max = max(lengths)
        batch = np.stack([np.pad(c, ((0, t_max - len(c)), (0, 0)))
                          for c in conds])
        raws = vocoder.generate(torch.from_numpy(batch))
        paths = {}
        for id_name, raw, length in zip(ids, raws, lengths):
            path = Synthesiser._out_path(id_name, hparams)
            audio_io.raw_to_file(path, _norm_loudness(raw[:length]), fs)
            logger.info("Wrote %s", path)
            paths[id_name] = path
        return paths

    @staticmethod
    def run_r9y9wavenet_mulaw_world_feats_synth(synth_output, hparams,
                                                epoch=None):
        """WaveNet vocoder conditioned on WORLD frame features
        {id: (frames, num_coded_sps + 3)}: the optional Merlin post-filter
        on the coded spectrum, frame -> sample-rate linear upsampling,
        then :meth:`run_wavenet_vocoder`."""
        fs = hparams.get("synth_fs", 16000)
        num_coded_sps = hparams.get("num_coded_sps", 60)
        samples_per_frame = int(
            fs * hparams.get("frame_size_ms",
                             hparams.get("frame_shift_ms", 5.0))
            / 1000.0)
        out = {}
        for id_name, feats in synth_output.items():
            feats = np.asarray(feats)
            if hparams.get("do_post_filtering"):
                sp, lf0, vuv, bap = \
                    WorldFeatLabelGen.convert_to_world_features(
                        feats, contains_deltas=False,
                        num_coded_sps=num_coded_sps)
                sp = mcep_ops.merlin_post_filter(
                    torch.from_numpy(np.ascontiguousarray(
                        sp, dtype=np.float32)),
                    mcep_ops.fs_to_mgc_alpha(fs)).numpy()
                feats = WorldFeatLabelGen.convert_from_world_features(
                    sp, lf0, vuv, bap)
            out[id_name] = sample_linearly(feats, samples_per_frame)
        return Synthesiser.run_wavenet_vocoder(out, hparams, epoch=epoch)


def _norm_loudness(raw, peak=0.85):
    raw = np.asarray(raw, np.float32)
    max_abs = np.abs(raw).max()
    if max_abs > peak:
        raw = raw / max_abs * peak
    return raw
