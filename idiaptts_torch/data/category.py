"""Categorical readers: the port's copy of
``idiaptts_tpu/data/category.py``.

``CategoryDataReader`` maps an utterance id to a category vector (a
speaker index for an EMB layer group, say) through a function;
``IntercrossDataReader`` swaps utterance ids within regex-defined groups
for speaker intercross training.  Readers produce numpy.
"""

import random
import re

import numpy as np

from idiaptts_torch.data.reader import DataReader


class CategoryDataReader(DataReader):
    """Maps an utterance id to a category vector via a function."""

    class Config(DataReader.Config):
        def __init__(self, name, get_category_fn=None, one_hot=False,
                     num_categories=None, **kwargs):
            super().__init__(name, **kwargs)
            self.get_category_fn = get_category_fn
            self.one_hot = one_hot
            self.num_categories = num_categories

        def create_reader(self):
            return CategoryDataReader(self)

    def __init__(self, config):
        super().__init__(config)
        self.get_category_fn = config.get_category_fn
        self.one_hot = config.one_hot
        self.num_categories = config.num_categories

    def load(self, id_name):
        category = self.get_category_fn(id_name)
        arr = np.atleast_2d(np.asarray(category, dtype=np.float32))
        if self.one_hot:
            eye = np.eye(self.num_categories, dtype=np.float32)
            arr = eye[arr.astype(np.int64).reshape(-1)]
        return arr

    def preprocess_sample(self, features, feature_idx=0):
        return features


class IntercrossDataReader:
    """Wraps a reader, swapping the queried id for another id from the
    same regex-defined group with some probability (intercross
    training)."""

    class Config:
        def __init__(self, wrapped_config, id_list, grouping_regex,
                     probability=1.0, seed=None):
            self.wrapped_config = wrapped_config
            self.id_list = id_list
            self.grouping_regex = grouping_regex
            self.probability = probability
            self.seed = seed

        def create_reader(self):
            return IntercrossDataReader(self)

    def __init__(self, config):
        self.wrapped = config.wrapped_config.create_reader()
        self.probability = config.probability
        self.rng = random.Random(config.seed)
        pattern = re.compile(config.grouping_regex)
        self.groups = {}
        self.group_of = {}
        for id_name in config.id_list:
            match = pattern.search(id_name)
            key = match.group(1) if match and match.groups() else \
                (match.group(0) if match else id_name)
            self.groups.setdefault(key, []).append(id_name)
            self.group_of[id_name] = key

    def __getattr__(self, item):
        return getattr(self.wrapped, item)

    def __getitem__(self, id_name):
        key = self.group_of.get(id_name)
        if key is not None and self.rng.random() < self.probability:
            candidates = self.groups[key]
            if len(candidates) > 1:
                swap = self.rng.choice(candidates)
                result = self.wrapped[swap]
                result["_id_list"] = id_name
                return result
        return self.wrapped[id_name]
