"""HTS-question linguistic featurisation: the port's copy of
``idiaptts_tpu/data/questions.py`` (numpy and the standard library).

Merlin-derived question matching (``wildcards2regex``, binary ``QS`` and
continuous ``CQS`` questions), state- and phone-aligned frame expansion
with the subphone features (Zhizheng's 9 by default, coarse coding and
the smaller sets), and :class:`QuestionLabelGen`, which reads the
frame-level question matrices (raw float32 ``<id>.questions`` files, or
npz) with their ``*-min-max`` statistics and generates them from HTK
labels (``gen_data``).

Questions are matched once per phone, by the native C++ matcher
(``native/question_matcher.cpp``, built into ``idiaptts_torch/_build/``)
when it builds and otherwise by Python regexes with identical answers,
then broadcast to frames with vectorised subphone features.  Output is
float32 ``(num_frames, num_questions + 9)``, the same arrays bit for bit
as the JAX package's.
"""

import glob
import os
import re

import numpy as np

from idiaptts_torch.data.normalisation import MinMaxExtractor
from idiaptts_torch.data.reader import LabelGen, NpzDataReader

_STATE_NUMBER = 5
_FRAME_NS = 50000  # HTK 100 ns units per 5 ms frame


def wildcards2regex(question, convert_number_pattern=False):
    """HTK wildcard pattern -> python regex (semantics of
    label_normalisation.wildcards2regex :866-889)."""
    prefix = postfix = ""
    if "*" in question:
        if not question.startswith("*"):
            prefix = r"\A"
        if not question.endswith("*"):
            postfix = r"\Z"
    question = question.strip("*")
    question = re.escape(question)
    question = question.replace(r"\*", ".*")
    question = prefix + question + postfix
    if convert_number_pattern:
        question = question.replace(re.escape(r"(\d+)"), r"(\d+)")
        question = question.replace(re.escape(r"([\d.]+)"), r"([\d\.]+)")
        question = question.replace(re.escape(r"([\d\.]+)"), r"([\d\.]+)")
    return question


class QuestionSet:
    """Parsed .hed question file: compiled binary (QS) and continuous
    (CQS) questions."""

    def __init__(self, file_questions):
        self.binary = []         # list of (key, [compiled regexes])
        self.continuous = []     # list of (key, compiled regex)
        self.raw_binary = []     # list of (key, [raw HTK patterns])
        self.raw_continuous = []  # list of (key, raw pattern)
        with open(file_questions) as f:
            for line in f:
                line = line.rstrip("\n")
                if len(line) <= 5:
                    continue
                kind, key = line.split()[0], line.split()[1]
                body = line.split("{", 1)[1].split("}", 1)[0].strip()
                patterns = body.split(",")
                if kind == "CQS":
                    assert len(patterns) == 1
                    regex = wildcards2regex(patterns[0],
                                            convert_number_pattern=True)
                    self.continuous.append((key, re.compile(regex)))
                    self.raw_continuous.append((key, patterns[0]))
                elif kind == "QS":
                    compiled = []
                    for pattern in patterns:
                        regex = wildcards2regex(pattern)
                        if "LL-" in key:
                            regex = "^" + regex
                        compiled.append(re.compile(regex))
                    self.binary.append((key, compiled))
                    self.raw_binary.append((key, patterns))
                else:
                    raise ValueError(
                        "Malformed question line: {}".format(line))
        self._native = None

    def native(self):
        """Native C++ matcher for this question set (built lazily into
        ``idiaptts_torch/_build/``; None when the toolchain is
        unavailable, and then :meth:`match` answers identically)."""
        if self._native is None:
            try:
                from idiaptts_torch.data.native_questions import \
                    NativeQuestionSet
                self._native = NativeQuestionSet(self)
            except Exception as e:
                import logging
                logging.getLogger(__name__).warning(
                    "Native question matcher unavailable: %s", e)
                self._native = False
        return self._native or None

    @property
    def dict_size(self):
        return len(self.binary) + len(self.continuous)

    def match(self, full_label):
        """One phone label -> (dict_size,) float answers."""
        out = np.zeros(self.dict_size, dtype=np.float32)
        i = 0
        for _, compiled_list in self.binary:
            for compiled in compiled_list:
                if compiled.search(full_label) is not None:
                    out[i] = 1.0
                    break
            i += 1
        for _, compiled in self.continuous:
            match = compiled.search(full_label)
            out[i] = float(match.group(1)) if match is not None else -1.0
            i += 1
        return out


def _parse_state_label(path):
    """HTK state-aligned label file -> list of
    (phone_label, [state frame counts])."""
    phones = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) == 1:
                phones.append((parts[0], None))
                continue
            start, end, label = int(parts[0]), int(parts[1]), parts[2]
            frames = (end - start) // _FRAME_NS
            state = int(label[-2])  # "...[k]"
            base = label[:-3]
            if state == 2:  # first state of a new phone
                phones.append((base, [frames]))
            else:
                phones[-1][1].append(frames)
    return phones


class HTSLabelNormalisation:
    """Question matching + state-aligned frame expansion."""

    def __init__(self, file_questions, add_frame_features=True,
                 subphone_feats="full", use_native=True):
        self.question_set = QuestionSet(file_questions)
        self.add_frame_features = add_frame_features
        self.subphone_feats = subphone_feats
        self.use_native = use_native
        self.frame_feature_size = {"full": 9, "state_only": 1,
                                   "frame_only": 1, "uniform_state": 2,
                                   "minimal_frame": 2, "coarse_coding": 4,
                                   "minimal_phoneme": 3,
                                   "none": 0}[subphone_feats]
        self.dict_size = self.question_set.dict_size
        self.dimension = self.dict_size + self.frame_feature_size \
            if (add_frame_features or subphone_feats != "none") \
            else self.dict_size

    # -- frame expansion -------------------------------------------------
    def load_labels_with_state_alignment(self, file_name):
        phones = _parse_state_label(file_name)
        native = self.question_set.native() if self.use_native else None
        blocks = []
        for base_label, state_frames in phones:
            answers = (native.match(base_label) if native is not None
                       else self.question_set.match(base_label))
            if state_frames is None:
                blocks.append(answers[None, :])
                continue
            state_frames = np.asarray(state_frames[:_STATE_NUMBER])
            phone_dur = int(state_frames.sum())
            if phone_dur == 0:
                continue
            blocks.append(self._expand_phone(answers, state_frames,
                                             phone_dur))
        return np.concatenate(blocks, axis=0).astype(np.float32)

    def load_labels_with_phone_alignment(self, file_name,
                                         durations=None):
        """Phone-aligned HTK labels (no state suffix) -> question
        matrix (label_normalisation.load_labels_with_phone_alignment
        :424-521 semantics).  Lines are either ``label`` alone or
        ``start end label``; the frame count comes from the timings
        (5 ms frames) or, when ``durations`` is given, from that
        per-phone frame-count sequence.  Valid ``subphone_feats``:
        ``minimal_phoneme`` (fraction fwd / fraction bwd / duration),
        ``coarse_coding`` (3 gaussians + duration) and ``none``."""
        if self.subphone_feats not in ("minimal_phoneme",
                                       "coarse_coding", "none"):
            raise ValueError(
                "subphone_feats '{}' is state-based; phone-aligned "
                "labels support minimal_phoneme/coarse_coding/none"
                .format(self.subphone_feats))
        native = self.question_set.native() if self.use_native else None
        blocks = []
        ph_count = 0
        with open(file_name) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) == 1:
                    full_label = parts[0]
                    # Label-only lines carry no timing; an explicit
                    # durations sequence still applies (synthesis use).
                    frame_number = int(durations[ph_count]) \
                        if durations is not None else 0
                else:
                    start, end, full_label = \
                        int(parts[0]), int(parts[1]), parts[2]
                    if durations is not None:
                        frame_number = int(durations[ph_count])
                    else:
                        frame_number = (end - start) // _FRAME_NS
                ph_count += 1
                answers = (native.match(full_label)
                           if native is not None
                           else self.question_set.match(full_label))
                if self.add_frame_features:
                    if frame_number == 0:
                        continue
                    block = np.empty((frame_number, self.dimension),
                                     dtype=np.float32)
                    block[:, :self.dict_size] = answers[None, :]
                    f0 = self.dict_size
                    i1 = np.arange(1, frame_number + 1,
                                   dtype=np.float32)
                    if self.subphone_feats == "minimal_phoneme":
                        block[:, f0 + 0] = i1 / frame_number
                        block[:, f0 + 1] = (frame_number - i1 + 1) \
                            / frame_number
                        block[:, f0 + 2] = frame_number
                    elif self.subphone_feats == "coarse_coding":
                        cc = self._coarse_coding(frame_number)
                        block[:, f0:f0 + 3] = cc
                        block[:, f0 + 3] = frame_number
                    blocks.append(block)
                elif self.subphone_feats == "none":
                    blocks.append(answers[None, :])
        return np.concatenate(blocks, axis=0).astype(np.float32)

    def _expand_phone(self, answers, state_frames, phone_dur):
        total = int(state_frames.sum())
        if not self.add_frame_features:
            if self.subphone_feats == "none":
                return answers[None, :]
        block = np.empty((total, self.dimension), dtype=np.float32)
        block[:, :self.dict_size] = answers[None, :]
        if self.frame_feature_size == 0:
            return block

        # Vectorised per-frame indices.
        state_idx = np.repeat(np.arange(1, len(state_frames) + 1),
                              state_frames)                       # 1..5
        frame_in_state = np.concatenate(
            [np.arange(n) for n in state_frames])                 # i
        frames_of_state = np.repeat(state_frames, state_frames)   # fn
        state_base = np.repeat(np.cumsum(state_frames)
                               - state_frames, state_frames)
        i1 = frame_in_state + 1.0

        f = self.dict_size
        if self.subphone_feats == "full":
            block[:, f + 0] = i1 / frames_of_state
            block[:, f + 1] = (frames_of_state - frame_in_state) \
                / frames_of_state
            block[:, f + 2] = frames_of_state
            block[:, f + 3] = state_idx
            block[:, f + 4] = _STATE_NUMBER + 1 - state_idx
            block[:, f + 5] = phone_dur
            block[:, f + 6] = frames_of_state / phone_dur
            block[:, f + 7] = (phone_dur - frame_in_state - state_base) \
                / phone_dur
            block[:, f + 8] = (state_base + i1) / phone_dur
        elif self.subphone_feats == "state_only":
            block[:, f] = state_idx
        elif self.subphone_feats == "frame_only":
            pos = state_base + i1
            block[:, f] = pos / phone_dur
        elif self.subphone_feats == "uniform_state":
            pos = state_base + i1
            block[:, f] = pos / phone_dur
            block[:, f + 1] = np.maximum(
                1, np.round(pos / phone_dur * _STATE_NUMBER))
        elif self.subphone_feats == "minimal_frame":
            block[:, f] = i1 / frames_of_state
            block[:, f + 1] = state_idx
        elif self.subphone_feats == "coarse_coding":
            cc = self._coarse_coding(phone_dur)
            pos = (state_base + frame_in_state).astype(int)
            block[:, f:f + 3] = cc[pos]
            block[:, f + 3] = phone_dur
        else:
            raise ValueError("Unknown subphone_feats: "
                             + self.subphone_feats)
        return block

    @staticmethod
    def _coarse_coding(phone_dur):
        """Three overlapping gaussians over the phone
        (compute_coarse_coding_features :717-737 semantics)."""
        npoints = 600
        x = np.linspace(-1.5, 1.5, npoints)
        sigma = 0.4
        base = np.exp(-0.5 * (x / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi))
        rel = (200.0 / phone_dur * np.arange(phone_dur)).astype(int)
        cc = np.stack([base[300 + rel], base[200 + rel], base[100 + rel]],
                      axis=1)
        return cc

    def perform_normalisation(self, file_id_list_name, id_list, dir_in,
                              dir_out=None, return_dict=False,
                              label_type="state_align"):
        """Extract question labels for all ids; accumulate min/max norm
        parameters; save raw float32 ``.questions`` files like the
        reference.  ``label_type``: "state_align" (default) or
        "phone_align" for labels without state indices."""
        loader = (self.load_labels_with_phone_alignment
                  if label_type == "phone_align"
                  else self.load_labels_with_state_alignment)
        extractor = MinMaxExtractor()
        label_dict = {}
        for file_id in id_list:
            labels = loader(
                os.path.join(dir_in, file_id + ".lab"))
            extractor.add_sample(labels)
            if dir_out is not None:
                out_path = os.path.join(dir_out, file_id + ".questions")
                os.makedirs(os.path.dirname(out_path), exist_ok=True)
                labels.astype(np.float32).tofile(out_path)
            if return_dict:
                label_dict[file_id] = labels
        norm_params = extractor.get_params()
        if dir_out is not None:
            extractor.save(os.path.join(dir_out, file_id_list_name))
        if return_dict:
            return label_dict, norm_params
        return norm_params


class QuestionLabelGen(NpzDataReader, LabelGen):
    """Question labels reader/extractor (QuestionLabelGen.py:31-352)."""

    ext_question = ".questions"

    class Config(NpzDataReader.Config):
        def __init__(self, *args, num_questions=None, **kwargs):
            kwargs.setdefault("norm_type",
                              NpzDataReader.Config.NormType.MIN_MAX)
            super().__init__(*args, **kwargs)
            self.num_questions = num_questions

        def create_reader(self):
            reader = QuestionLabelGen(self)
            try:
                reader.get_normalisation_params()
            except (AssertionError, FileNotFoundError):
                pass
            return reader

    def __init__(self, config_or_dir, num_questions=None):
        if isinstance(config_or_dir, QuestionLabelGen.Config):
            config = config_or_dir
            self.num_questions = config.num_questions
        else:
            config = QuestionLabelGen.Config(
                name="questions", directory=config_or_dir,
                num_questions=num_questions)
            self.num_questions = num_questions
        super().__init__(config)

    def load(self, id_name):
        id_name = os.path.splitext(os.path.basename(id_name))[0]
        for directory in self.directory:
            raw_path = os.path.join(directory, id_name + self.ext_question)
            if os.path.isfile(raw_path):
                arr = np.fromfile(raw_path, dtype=np.float32)
                if self.num_questions:
                    arr = arr.reshape(-1, self.num_questions)
                return arr
        return super().load(id_name)

    @staticmethod
    def load_sample(id_name, dir_out=None, num_questions=None):
        return QuestionLabelGen(dir_out, num_questions).load(id_name)

    @staticmethod
    def gen_data(dir_in, file_questions, dir_out=None, file_id_list="",
                 id_list=None, return_dict=False):
        """Generate question labels from HTK state-aligned labels
        (QuestionLabelGen.gen_data :152-203)."""
        if id_list is None:
            id_list = [os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(os.path.join(dir_in, "*.lab"))]
            file_id_list_name = "all"
        else:
            file_id_list_name = os.path.splitext(
                os.path.basename(file_id_list))[0] or "all"
            id_list = [os.path.basename(i) for i in id_list]
        if dir_out is not None:
            os.makedirs(dir_out, exist_ok=True)
        operator = HTSLabelNormalisation(file_questions)
        result = operator.perform_normalisation(
            file_id_list_name, id_list, dir_in, dir_out,
            return_dict=return_dict)
        if return_dict:
            label_dict, (vmin, vmax) = result
            return label_dict, vmin, vmax
        vmin, vmax = result
        return vmin, vmax

    # -- phoneme identification utilities --------------------------------
    @staticmethod
    def get_HTK_label_timings_ms(htk_label):
        """Start/end time of one HTK label line in ms
        (QuestionLabelGen.py:205-214)."""
        parts = htk_label.split()
        return [int(parts[0]) / 1000, int(parts[1]) / 1000]

    @staticmethod
    def questions_to_phoneme_indices(questions, phoneme_indices):
        """Frame-level questions -> phoneme index per frame using the
        question columns that one-hot-identify the current phoneme
        (QuestionLabelGen.questions_to_phoneme_indices :217-243)."""
        subset = questions[:, phoneme_indices]
        indices = np.argmax(subset, axis=1)
        return indices

    @staticmethod
    def questions_to_phoneme_per_frame(questions, phoneme_indices,
                                       phoneme_list):
        indices = QuestionLabelGen.questions_to_phoneme_indices(
            questions, phoneme_indices)
        return np.array([phoneme_list[i] for i in indices])

    @staticmethod
    def questions_to_phonemes(questions, phoneme_indices, phoneme_list):
        """Collapse frame-level phonemes to (start_frame, phoneme) runs."""
        per_frame = QuestionLabelGen.questions_to_phoneme_per_frame(
            questions, phoneme_indices, phoneme_list)
        changes = np.concatenate(
            [[0], np.where(per_frame[1:] != per_frame[:-1])[0] + 1])
        return [(int(i), per_frame[i]) for i in changes]


def main(argv=None):
    """CLI: question labels of a corpus of HTS state-aligned labels."""
    import argparse
    parser = argparse.ArgumentParser(
        description="Generate HTS question labels.")
    parser.add_argument("-l", "--dir_labels", required=True)
    parser.add_argument("-q", "--file_questions", required=True)
    parser.add_argument("-o", "--dir_out", required=True)
    parser.add_argument("-i", "--file_id_list", default=None)
    args = parser.parse_args(argv)
    id_list = None
    if args.file_id_list:
        with open(args.file_id_list) as f:
            id_list = [line.strip() for line in f if line.strip()]
    QuestionLabelGen.gen_data(args.dir_labels, args.file_questions,
                              dir_out=args.dir_out,
                              file_id_list=args.file_id_list or "",
                              id_list=id_list)


if __name__ == "__main__":
    main()
