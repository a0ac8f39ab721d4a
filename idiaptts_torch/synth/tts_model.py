"""End-to-end text -> speech pipeline glue: the port of
``idiaptts_tpu/synth/tts_model.py``.

Front end (the built-in one, or an external ``front_end_cmd``
subprocess such as Festival's makeLabels.sh) -> phone-level questions
-> duration model -> durations written into state-aligned HTS labels ->
frame-level questions -> acoustic model -> WORLD synthesis
(``TTSModel.run_DM_AM``), and the same path online through
:class:`TextToSpeechServer` (``TTSModel.serve``).  The pipeline can
equally start from precomputed HTS full labels (``label_dir``).

The front half runs on the host; the duration and acoustic models, the
MLPG and the vocoder run on ``hparams.device`` through the port's
trainers (``"cuda"`` unless set to ``"cpu"``).
"""

import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np

from idiaptts_torch.data.phonemes import PhonemeDurationLabelGen
from idiaptts_torch.data.questions import (HTSLabelNormalisation,
                                           QuestionLabelGen, QuestionSet)
from idiaptts_torch.data.reader import NpzDataReader
from idiaptts_torch.synth.frontend import BuiltinFrontEnd

logger = logging.getLogger(__name__)

_FRAME_NS = 50000

_front_ends = {}
_front_ends_lock = threading.Lock()


def _front_end(lexicon, accent):
    with _front_ends_lock:
        key = (lexicon, accent)
        if key not in _front_ends:
            _front_ends[key] = BuiltinFrontEnd(lexicon_path=lexicon,
                                               accent=accent)
        return _front_ends[key]


class TTSModel:

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        """Combined duration+acoustic hparams plus the full-TTS keys
        (TTSModel.create_hparams :31-57 role)."""
        from idiaptts_torch.train.acoustic import AcousticModelTrainer
        from idiaptts_torch.train.duration import DurationModelTrainer
        hparams = AcousticModelTrainer.create_hparams(hparams_string,
                                                      verbose=False)
        hparams_dur = DurationModelTrainer.create_hparams(
            hparams_string, verbose=False)
        hparams.override_from_hparam(hparams_dur)
        hparams.add_hparams(
            front_end=None,
            front_end_cmd=None,
            front_end_accent=None,
            festival_dir=None,
            file_symbol_dict=None,
            num_phoneme_states=None,
            duration_labels_dir=None,
            duration_norm_file_name=None,
            duration_model=None,
            question_labels_norm_file=None,
            world_features_dir=None,
            acoustic_model=None)
        if verbose:
            logger.info(hparams.get_debug_string())
        return hparams

    @staticmethod
    def run_front_end(hparams, input_strings, out_dir):
        """Text -> HTS full labels.

        With ``front_end_cmd`` configured: external subprocess (the
        reference's Festival makeLabels.sh path, TTSModel.py:88-98).
        Otherwise: the self-contained builtin front end
        (:mod:`idiaptts_torch.synth.frontend` — lexicon/rule G2P +
        full-context label emission), so the text->speech pipeline
        works on a machine without Festival.  ``hparams.front_end``
        may name a lexicon file via ``lexicon:<path>``;
        ``hparams.front_end_accent`` selects the pronunciation variant
        ("en-US" default / "en-GB" — the reference's Am-vs-unilex-Br
        Festival choice, ``Text2FestivalReadyAm.pl`` vs
        ``utt2lab-unilex-rpx.sh``).  The built-in front end is built once
        per lexicon and accent (loading the lexicon takes ~0.35 s) and
        reused, read-only, by every call."""
        front_end_cmd = hparams.get("front_end_cmd")
        if not front_end_cmd:
            spec = hparams.get("front_end") or ""
            lexicon = spec.split(":", 1)[1] \
                if spec.startswith("lexicon:") else None
            accent = hparams.get("front_end_accent") or "en-US"
            return _front_end(lexicon, accent).write_labels(input_strings,
                                                            out_dir)
        os.makedirs(out_dir, exist_ok=True)
        synth_txt = os.path.join(out_dir, "synth.txt")
        with open(synth_txt, "w") as f:
            for i, text in enumerate(input_strings):
                f.write("utt{:03d} {}\n".format(i, text))
        subprocess.run([front_end_cmd, synth_txt, out_dir], check=True)
        return [os.path.splitext(p)[0]
                for p in sorted(os.listdir(out_dir))
                if p.endswith(".lab")]

    @staticmethod
    def strip_timings(label_lines):
        """Remove start/end timings and state suffixes from full-label
        lines (TTSModel.py:101-112 role)."""
        stripped = []
        for line in label_lines:
            parts = line.split()
            label = parts[-1]
            if label.endswith("]"):
                label = label[:-3]
            stripped.append(label)
        # Deduplicate consecutive states of the same phone.
        out = []
        for label in stripped:
            if not out or out[-1] != label:
                out.append(label)
        return out

    @staticmethod
    def phone_question_matrix(operator, full_labels):
        """Phone-level question vectors for the duration model (shared
        by run_DM_AM and the serving path)."""
        return np.stack([operator.question_set.match(lab)
                         for lab in full_labels]).astype(np.float32)

    @staticmethod
    def write_alignment(dir_out, id_name, full_labels, durations):
        """Clamp predicted durations to >=1 frame, write the
        state-aligned label file and return its path (shared by
        run_DM_AM and the serving path)."""
        os.makedirs(dir_out, exist_ok=True)
        durations = np.maximum(durations, 1)
        lines = TTSModel.write_durations_into_labels(full_labels,
                                                     durations)
        path = os.path.join(dir_out, id_name + ".lab")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    @staticmethod
    def write_durations_into_labels(full_labels, durations):
        """Create state-aligned label lines from per-phone 5-state
        durations (TTSModel.py:134-147 role)."""
        lines = []
        time = 0
        for phone_idx, label in enumerate(full_labels):
            for state in range(durations.shape[1]):
                dur_frames = int(durations[phone_idx, state])
                start = time
                end = time + dur_frames * _FRAME_NS
                lines.append("{} {} {}[{}]".format(start, end, label,
                                                   state + 2))
                time = end
        return lines

    @staticmethod
    def serve(hparams, max_batch=16, max_wait_ms=10.0):
        """Online text->speech serving: a
        :class:`TextToSpeechServer` whose ``submit(text)`` returns a
        future resolving to a waveform.  Per request the host runs
        front end -> duration model -> question expansion; the acoustic
        model + vocoder run through the request-batching
        :class:`~idiaptts_torch.synth.server.SynthesisServer`, so
        concurrent texts share device dispatches.  Requires the same
        hparams as :meth:`run_DM_AM` (initialised ``duration_trainer``
        / ``acoustic_trainer``, ``question_file``)."""
        return TextToSpeechServer(hparams, max_batch=max_batch,
                                  max_wait_ms=max_wait_ms)

    @staticmethod
    def load_trainers(hparams):
        """Build checkpoint-loaded duration and acoustic trainers from
        paths (the reference's run_DM_AM interface, TTSModel.py:115-131
        and :148-163): ``duration_model`` / ``acoustic_model`` point at
        checkpoint directories (``<out_dir>/<model_name>``),
        ``duration_labels_dir`` holds the duration-side question norm
        stats, ``duration_norm_file_name`` the duration output norm
        stats, ``question_labels_norm_file`` the acoustic question norm
        stats and ``world_features_dir`` the cmp norm/covariance stats.
        Returns ``(duration_trainer, acoustic_trainer)``.  The
        checkpoints are the port's own (``torch.save`` state dicts; the
        JAX package's msgpack/orbax checkpoints do not load here), and
        both trainers run on ``hparams.device``."""
        from idiaptts_torch.train.acoustic import AcousticModelTrainer
        from idiaptts_torch.train.duration import DurationModelTrainer

        def _split(path):
            path = os.path.normpath(path)
            return os.path.dirname(path), os.path.basename(path)

        assert hparams.get("duration_model") is not None, \
            "hparams.duration_model checkpoint path is needed."
        assert hparams.get("acoustic_model") is not None, \
            "hparams.acoustic_model checkpoint path is needed."

        dur_hp = DurationModelTrainer.create_hparams()
        dur_out, dur_name = _split(hparams.duration_model)
        dur_hp.setattr_no_type_check("out_dir", dur_out)
        dur_hp.setattr_no_type_check("model_name", dur_name)
        dur_hp.setattr_no_type_check("load_from_checkpoint", True)
        dur_hp.setattr_no_type_check("epochs", 0)
        dur_hp.setattr_no_type_check("start_with_test", False)
        dur_hp.setattr_no_type_check("device", hparams.get("device", "cuda"))
        dur_labels_dir = hparams.get("duration_labels_dir")
        dur_trainer = DurationModelTrainer(
            dur_hp, [], dir_phoneme_labels=dur_labels_dir)
        # Phone-level questions carry dict_size columns (no subphone
        # features), derived from the question file.
        dict_size = QuestionSet(hparams.question_file).dict_size
        q_cfg = QuestionLabelGen.Config(
            name="questions", directory=dur_labels_dir,
            num_questions=dict_size)
        dur_norm = hparams.get("duration_norm_file_name")
        d_kwargs = {"norm_params_path": dur_norm}
        if not dur_norm:
            d_kwargs["norm_type"] = NpzDataReader.Config.NormType.NONE
        d_cfg = PhonemeDurationLabelGen.Config(
            name="durations", directory=None, **d_kwargs)
        dur_trainer.init(dur_hp, data_reader_configs=[q_cfg, d_cfg])

        am_hp = AcousticModelTrainer.create_hparams()
        am_out, am_name = _split(hparams.acoustic_model)
        am_hp.setattr_no_type_check("out_dir", am_out)
        am_hp.setattr_no_type_check("model_name", am_name)
        am_hp.setattr_no_type_check("load_from_checkpoint", True)
        am_hp.setattr_no_type_check("epochs", 0)
        am_hp.setattr_no_type_check("start_with_test", False)
        for key in ("num_questions", "num_coded_sps", "sp_type",
                    "synth_fs", "num_bap", "add_deltas", "device"):
            if hparams.has_value(key):
                am_hp.setattr_no_type_check(key, hparams.get(key))
        am_trainer = AcousticModelTrainer(
            am_hp, [],
            dir_question_labels=hparams.get(
                "question_labels_norm_file"),
            dir_world_features=hparams.get("world_features_dir"))
        am_trainer.init(am_hp)
        return dur_trainer, am_trainer

    @staticmethod
    def run_DM_AM(hparams, input_strings=None, label_dir=None,
                  id_list=None):
        """Full pipeline: (text | labels) -> durations -> questions ->
        acoustic model -> wav files (TTSModel.run_DM_AM :59-165).

        Requires in hparams: ``question_file``, ``synth_dir`` and
        either ``duration_trainer`` + ``acoustic_trainer`` (initialised
        task trainers) or the reference's checkpoint-path interface
        (``duration_model`` / ``acoustic_model`` + norm-stat dirs, see
        :meth:`load_trainers`).
        """
        work_dir = hparams.get("synth_dir") or os.path.join(
            hparams.get("out_dir") or ".", "tts")
        os.makedirs(work_dir, exist_ok=True)

        if label_dir is None:
            label_dir = os.path.join(work_dir, "labels")
            id_list = TTSModel.run_front_end(hparams, input_strings,
                                             label_dir)
        elif id_list is None:
            id_list = [os.path.splitext(p)[0]
                       for p in sorted(os.listdir(label_dir))
                       if p.endswith(".lab")]

        duration_trainer = hparams.get("duration_trainer")
        acoustic_trainer = hparams.get("acoustic_trainer")
        if duration_trainer is None or acoustic_trainer is None:
            duration_trainer, acoustic_trainer = \
                TTSModel.load_trainers(hparams)
        question_file = hparams.question_file

        # 1. Phone-level questions for the duration model.
        operator = HTSLabelNormalisation(question_file,
                                         add_frame_features=False,
                                         subphone_feats="none")
        dur_question_dir = os.path.join(work_dir, "dur_questions")
        os.makedirs(dur_question_dir, exist_ok=True)
        phone_labels = {}
        for id_name in id_list:
            with open(os.path.join(label_dir, id_name + ".lab")) as f:
                lines = [l for l in f if l.strip()]
            full_labels = TTSModel.strip_timings(lines)
            phone_labels[id_name] = full_labels
            TTSModel.phone_question_matrix(
                operator, full_labels).tofile(
                os.path.join(dur_question_dir,
                             id_name + ".questions"))

        # 2. Predict durations.
        duration_trainer.datareaders["questions"].directory = \
            [dur_question_dir]
        durations = duration_trainer.forward(hparams, id_list)

        # 3. Write predicted durations into state-aligned labels.
        aligned_dir = os.path.join(work_dir, "label_state_align")
        for id_name in id_list:
            TTSModel.write_alignment(aligned_dir, id_name,
                                     phone_labels[id_name],
                                     durations[id_name])

        # 4. Frame-level questions from the new alignment.
        am_question_dir = os.path.join(work_dir, "questions")
        QuestionLabelGen.gen_data(aligned_dir, question_file,
                                  dir_out=am_question_dir,
                                  id_list=id_list)

        # 5. Acoustic model -> WORLD synthesis.
        acoustic_trainer.datareaders["questions"].directory = \
            [am_question_dir]
        return acoustic_trainer.synth(hparams, id_list)


class TextToSpeechServer:
    """Online text->speech serving (TTSModel.serve).

    Per request the host runs the run_DM_AM front half (front end ->
    phone questions -> duration model -> state-aligned labels -> frame
    questions -> normalisation); the waveform half goes through the
    acoustic trainer's request-batching
    :class:`~idiaptts_torch.synth.server.SynthesisServer`, so concurrent
    texts share fused device dispatches.  Single-input acoustic models
    (questions only); the duration forward is serialised by a lock
    (its reader directory is redirected per request)."""

    def __init__(self, hparams, max_batch=16, max_wait_ms=10.0):
        self.hparams = hparams
        self.duration_trainer = hparams.get("duration_trainer")
        self.acoustic_trainer = hparams.get("acoustic_trainer")
        if self.duration_trainer is None or self.acoustic_trainer is None:
            self.duration_trainer, self.acoustic_trainer = \
                TTSModel.load_trainers(hparams)
        self.question_file = hparams.question_file
        self.server = self.acoustic_trainer.serve(
            hparams, max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.reader_q = self.acoustic_trainer.datareaders["questions"]
        self._phone_operator = HTSLabelNormalisation(
            self.question_file, add_frame_features=False,
            subphone_feats="none")
        self._frame_operator = HTSLabelNormalisation(self.question_file)
        self.work_root = tempfile.mkdtemp(prefix="tts_serve_")
        self._dur_lock = threading.Lock()
        self._counter = 0
        # Host seconds of the front half, summed over requests.
        self._front_seconds = 0.0

    def front_half(self, text):
        """One utterance text -> its normalised (T, D) float32 frame
        questions: front end -> phone questions -> duration model ->
        state-aligned labels -> frame questions, normalised like the
        acoustic reader's training inputs."""
        with self._dur_lock:
            self._counter += 1
            id_name = "req{:05d}".format(self._counter)
        work = os.path.join(self.work_root, id_name)
        label_dir = os.path.join(work, "labels")
        utt_ids = TTSModel.run_front_end(self.hparams, [text],
                                         label_dir)
        with open(os.path.join(label_dir, utt_ids[0] + ".lab")) as f:
            lines = [l for l in f if l.strip()]
        full_labels = TTSModel.strip_timings(lines)

        # Phone-level questions -> duration model (serialised: the
        # duration reader's directory is redirected per request).
        dur_q_dir = os.path.join(work, "dur_questions")
        os.makedirs(dur_q_dir, exist_ok=True)
        TTSModel.phone_question_matrix(
            self._phone_operator, full_labels).tofile(
            os.path.join(dur_q_dir, id_name + ".questions"))
        with self._dur_lock:
            self.duration_trainer.datareaders["questions"].directory \
                = [dur_q_dir]
            durations = self.duration_trainer.forward(
                self.hparams, [id_name])[id_name]

        aligned_path = TTSModel.write_alignment(work, id_name,
                                                full_labels, durations)
        frame_q = self._frame_operator.load_labels_with_state_alignment(
            aligned_path)
        return np.asarray(self.reader_q.preprocess_sample(frame_q),
                          np.float32)

    def submit(self, text):
        """One utterance text -> Future[(num_frames * hop,) float32]."""
        t0 = time.perf_counter()
        frame_q = self.front_half(text)
        future = self.server.submit(frame_q)
        with self._dur_lock:
            self._front_seconds += time.perf_counter() - t0
        return future

    def synth(self, text):
        """Blocking convenience wrapper."""
        return self.submit(text).result()

    def stats(self):
        """The synthesis server's counters (``busy_seconds``: the
        batches' wall time on the device side) and ``front_seconds``, the
        host time of the requests' front halves."""
        out = self.server.stats()
        with self._dur_lock:
            out["front_seconds"] = self._front_seconds
        return out

    def shutdown(self, wait=True):
        self.server.shutdown(wait=wait)
        shutil.rmtree(self.work_root, ignore_errors=True)
