"""HTS question labels: the loading path of
``idiaptts_tpu/data/questions.py``.

:class:`QuestionLabelGen` reads the frame-level question matrices that
the JAX package's extractor wrote (raw float32 ``<id>.questions`` files,
or npz) and min-max normalises them with the ``*-min-max`` statistics
beside them.  Generating question labels from HTK labels (question
matching and subphone features) is not ported yet: ``gen_data`` raises.
"""

import os

import numpy as np

from idiaptts_torch.data.reader import LabelGen, NpzDataReader

_LATER = ("question-label generation is not ported yet; ROADMAP.md queue 1 "
          "item 10 (feature extraction) ports it.  Generate the labels with "
          "idiaptts_tpu.data.questions.QuestionLabelGen.gen_data")


class QuestionLabelGen(NpzDataReader, LabelGen):
    """Question labels reader."""

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
    def gen_data(*args, **kwargs):
        raise NotImplementedError(_LATER)
