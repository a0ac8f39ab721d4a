"""Audio cleanup command-line tools: the port of
``idiaptts_tpu/data/audio_tools.py`` on the port's
:mod:`idiaptts_torch.ops.audio_io` and :mod:`idiaptts_torch.ops.enhancement`.

Five tools over a directory of wavs: silence removal, resampling, an FIR
high-pass, RMS loudness normalisation and noise reduction (spectral
subtraction with optional dereverberation, on the card unless
``--device cpu``).

Usage: ``python -m idiaptts_torch.data.audio_tools <tool> --dir_wav ...
--dir_out ... [--id_list file]``.
"""

import argparse
import glob
import logging
import os

from idiaptts_torch.ops import audio_io

logger = logging.getLogger(__name__)


def _iter_ids(dir_wav, id_list_path):
    if id_list_path:
        with open(id_list_path) as f:
            return [line.strip() for line in f if line.strip()]
    return [os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(os.path.join(dir_wav, "*.wav"))]


def silence_remove(dir_wav, dir_out, id_list=None,
                   silence_db=-50.0, chunk_ms=10, keep_ms=0):
    for id_name in _iter_ids(dir_wav, id_list):
        raw, fs = audio_io.get_raw(os.path.join(dir_wav, id_name + ".wav"))
        trimmed, _, _ = audio_io.trim_silence(raw, fs, silence_db,
                                              chunk_ms, keep_ms)
        audio_io.raw_to_file(os.path.join(dir_out, id_name + ".wav"),
                             trimmed, fs)


def down_sampling(dir_wav, dir_out, id_list=None, target_fs=16000):
    for id_name in _iter_ids(dir_wav, id_list):
        raw, fs = audio_io.get_raw(os.path.join(dir_wav, id_name + ".wav"))
        audio_io.raw_to_file(os.path.join(dir_out, id_name + ".wav"),
                             audio_io.resample(raw, fs, target_fs),
                             target_fs)


def high_pass_filter(dir_wav, dir_out, id_list=None, cutoff=70.0,
                     order=1001):
    for id_name in _iter_ids(dir_wav, id_list):
        raw, fs = audio_io.get_raw(os.path.join(dir_wav, id_name + ".wav"))
        audio_io.raw_to_file(
            os.path.join(dir_out, id_name + ".wav"),
            audio_io.highpass_filter(raw, fs, cutoff, order), fs)


def normalize_loudness(dir_wav, dir_out, id_list=None, target_dbfs=-20.0):
    for id_name in _iter_ids(dir_wav, id_list):
        raw, fs = audio_io.get_raw(os.path.join(dir_wav, id_name + ".wav"))
        audio_io.raw_to_file(os.path.join(dir_out, id_name + ".wav"),
                             audio_io.rms_normalise(raw, target_dbfs), fs)


def noise_reduction(dir_wav, dir_out, id_list=None, t60=None,
                    minimum_gain_db=-10.0, device="cuda"):
    """Single-channel noise reduction, and dereverberation when ``t60``
    is given: :func:`idiaptts_torch.ops.enhancement.enhance` on
    ``device``."""
    from idiaptts_torch.ops.enhancement import enhance
    for id_name in _iter_ids(dir_wav, id_list):
        raw, fs = audio_io.get_raw(os.path.join(dir_wav, id_name + ".wav"))
        cleaned = enhance(raw, fs, t60=t60, minimum_gain_db=minimum_gain_db,
                          device=device)
        audio_io.raw_to_file(os.path.join(dir_out, id_name + ".wav"),
                             cleaned, fs)


_TOOLS = {
    "silence_remove": silence_remove,
    "down_sampling": down_sampling,
    "high_pass_filter": high_pass_filter,
    "normalize_loudness": normalize_loudness,
    "noise_reduction": noise_reduction,
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("tool", choices=sorted(_TOOLS))
    parser.add_argument("--dir_wav", required=True)
    parser.add_argument("--dir_out", required=True)
    parser.add_argument("--id_list", default=None)
    parser.add_argument("--target_fs", type=int, default=16000)
    parser.add_argument("--cutoff", type=float, default=70.0)
    parser.add_argument("--target_dbfs", type=float, default=-20.0)
    parser.add_argument("--silence_db", type=float, default=-50.0)
    parser.add_argument("--t60", type=float, default=None,
                        help="reverberation time for dereverberation")
    parser.add_argument("--device", default="cuda",
                        help="where noise_reduction runs")
    args = parser.parse_args(argv)
    os.makedirs(args.dir_out, exist_ok=True)
    kwargs = {}
    if args.tool == "down_sampling":
        kwargs["target_fs"] = args.target_fs
    elif args.tool == "high_pass_filter":
        kwargs["cutoff"] = args.cutoff
    elif args.tool == "normalize_loudness":
        kwargs["target_dbfs"] = args.target_dbfs
    elif args.tool == "silence_remove":
        kwargs["silence_db"] = args.silence_db
    elif args.tool == "noise_reduction":
        kwargs["device"] = args.device
        if args.t60:
            kwargs["t60"] = args.t60
    _TOOLS[args.tool](args.dir_wav, args.dir_out, args.id_list, **kwargs)


if __name__ == "__main__":
    main()
