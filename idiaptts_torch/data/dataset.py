"""Dataset layer: the port's copy of ``idiaptts_tpu/data/dataset.py``.

``DatareadersDataset`` merges several readers per utterance
(duplicate-key detection, ``match_length`` trims, ``max_frames`` crops
propagated to matched readers).  ``WindowingDatareadersDataset`` cuts
each utterance into fixed-size windows and hands the trainer's batcher
one work item per window.  ``collate_batch`` pads every batch to a
length bucket and emits explicit sequence masks for the masked losses;
the buckets bound the set of shapes the kernels see, as they bounded
XLA's compiled programs.  ``batch_decollate`` undoes it.
"""

import math
import random as _random

import numpy as np


class DatareadersDataset:
    """Merges several data readers per utterance id."""

    def __init__(self, id_list, datareaders, random_select=True,
                 rng=None):
        self.id_list = list(id_list)
        self.datareaders = list(datareaders)
        self.random_select = random_select
        self.rng = rng or _random.Random()

    def __len__(self):
        return len(self.id_list)

    def __getitem__(self, item):
        return self.get_id_name(self.id_list[item])

    def get_id_name(self, id_name):
        output = {}
        for reader in self.datareaders:
            reader_output = reader[id_name]
            for key in reader_output:
                if key != "_id_list" and key in output:
                    raise KeyError(
                        "Feature {} defined twice.".format(key))
            output.update(reader_output)
        self._match_output_lengths(output, id_name)
        self._match_max_frames(output, id_name)
        return output, self

    def get_input_dim(self, input_names):
        """Summed feature width of ``input_names`` in the first sample
        (a 1-D feature counts as one channel)."""
        sample, _ = self[0]
        return sum(1 if np.ndim(sample[name]) <= 1
                   else np.asarray(sample[name]).shape[-1]
                   for name in input_names)

    def get_datareader_by_name(self, name):
        for reader in self.datareaders:
            if reader.name == name:
                return reader
        raise KeyError(name)

    def get_datareader_by_output_name(self, name):
        for reader in self.datareaders:
            if name in reader.output_names:
                return reader
        raise KeyError(name)

    # -- match_length -----------------------------------------------------
    def _match_output_lengths(self, output, id_name):
        """Iteratively trim readers to their reference lengths until the
        graph is stable; tolerates cycles (each pass trims to the
        current shortest)."""
        for _ in range(len(self.datareaders) + 1):
            trimmed = False
            for reader in self.datareaders:
                if reader.match_length is None:
                    continue
                ref_lengths = self._ref_lengths(reader.match_length,
                                                output)
                for key in reader.output_names:
                    value = output[key]
                    new_value, did = self._trim_to(reader, value,
                                                   ref_lengths)
                    if did:
                        output[key] = new_value
                        trimmed = True
            if not trimmed:
                return

    def _ref_lengths(self, match_names, output):
        lengths = []
        for name in match_names:
            if name in output:
                lengths.append(len(output[name]))
            else:
                reader = self.get_datareader_by_output_name(name)
                lengths.append(len(output[reader.output_names[0]]))
        return lengths

    @staticmethod
    def _trim_to(reader, value, ref_lengths):
        trim_width = []
        do_trim = False
        for dim, ref_len in enumerate(ref_lengths[:value.ndim]):
            diff = value.shape[dim] - ref_len
            if diff > 0:
                front = diff // 2
                trim_width.append((front, diff - front))
                do_trim = True
            else:
                trim_width.append((0, 0))
        if not do_trim:
            return value, False
        trim_width += [(0, 0)] * (value.ndim - len(trim_width))
        return reader.trim(value, trim_width), True

    # -- max_frames crops -------------------------------------------------
    def _match_max_frames(self, output, id_name):
        """Random (or leading) crop to max_frames, propagated through the
        match_length graph so paired features stay aligned."""
        for reader in self.datareaders:
            if reader.max_frames is None:
                continue
            length = len(output[reader.output_names[0]])
            if length <= reader.max_frames:
                continue
            if reader.random_select and self.random_select:
                start = self.rng.randint(0, length - reader.max_frames)
            else:
                start = 0
            group = self._crop_group(reader)
            for member in group:
                factor = None
                for key in member.output_names:
                    value = output[key]
                    m_len = len(value)
                    if factor is None:
                        factor = max(1, round(m_len / length))
                    s = start * factor
                    e = s + reader.max_frames * factor
                    output[key] = value[s:min(e, m_len)]

    def _crop_group(self, reader):
        """Readers connected to ``reader`` through match_length."""
        group = {id(reader): reader}
        frontier = [reader]
        while frontier:
            current = frontier.pop()
            names = current.match_length or ()
            for name in names:
                try:
                    other = self.get_datareader_by_output_name(name)
                except KeyError:
                    continue
                if id(other) not in group:
                    group[id(other)] = other
                    frontier.append(other)
            for other in self.datareaders:
                if id(other) in group or other.match_length is None:
                    continue
                if any(n in current.output_names
                       for n in other.match_length):
                    group[id(other)] = other
                    frontier.append(other)
        return list(group.values())


class WindowingDatareadersDataset(DatareadersDataset):
    """Fixed-size windows over long utterances, deterministic.
    ``work_items``/``get_work_item`` feed the trainer's batcher one item
    per window; ``__iter__`` yields the same windows."""

    def __init__(self, id_list, datareaders, window_size=500,
                 window_step=50, **kwargs):
        super().__init__(id_list, datareaders, **kwargs)
        self.window_size = window_size
        self.window_step = window_step

    @staticmethod
    def _seq_length(output):
        """Windowable length: the shortest sequence feature (length-1
        per-utterance statics such as speaker ids do not cap it)."""
        lens = [len(v) for k, v in output.items()
                if k != "_id_list" and np.ndim(v) >= 1 and len(v) > 1]
        return min(lens) if lens else 1

    def _num_windows(self, length):
        return max(1, 1 + math.ceil((length - self.window_size)
                                    / self.window_step))

    def _window(self, output, w, num_windows):
        length = self._seq_length(output)
        start = w * self.window_step
        end = min(start + self.window_size, length)
        window = {k: (v if k == "_id_list"
                      or np.ndim(v) < 1 or len(v) <= 1
                      else v[start:end])
                  for k, v in output.items()}
        window["_window_idx"] = w
        window["_num_windows"] = num_windows
        return window

    def work_items(self, id_list):
        items = []
        for id_name in id_list:
            output, _ = self.get_id_name(id_name)
            nw = self._num_windows(self._seq_length(output))
            items.extend((id_name, w, nw) for w in range(nw))
        return items

    def get_work_item(self, item):
        if not isinstance(item, tuple):
            return self.get_id_name(item)
        id_name, w, nw = item
        output, _ = self.get_id_name(id_name)
        return self._window(output, w, nw), self

    def __iter__(self):
        for id_name in self.id_list:
            output, _ = self.get_id_name(id_name)
            num_windows = self._num_windows(self._seq_length(output))
            for w in range(num_windows):
                yield self._window(output, w, num_windows), self


DEFAULT_BUCKET_BOUNDARIES = (128, 256, 512, 1024, 2048, 4096)


def bucket_length(length, boundaries=DEFAULT_BUCKET_BOUNDARIES):
    """Smallest boundary >= length (or round up to boundary multiples
    beyond the largest)."""
    for b in boundaries:
        if length <= b:
            return b
    largest = boundaries[-1]
    return int(math.ceil(length / largest) * largest)


def collate_batch(samples, bucket_boundaries=DEFAULT_BUCKET_BOUNDARIES,
                  pad_to_bucket=True, batch_first=True):
    """List of sample dicts -> batch dict of padded arrays + masks.

    Every feature is padded along time to the batch bucket length;
    ``_lengths`` holds per-feature original lengths and ``_seq_mask``
    a (B, T, 1) float mask of valid frames (based on the longest
    feature group).  batch_first=False transposes to (T, B, ...).
    """
    keys = [k for k in samples[0] if not k.startswith("_")]
    batch = {}
    lengths = {}
    max_len_overall = 0
    for key in keys:
        feats = [np.atleast_1d(np.asarray(s[key])) for s in samples]
        lens = np.array([len(f) for f in feats], dtype=np.int32)
        max_len = int(lens.max())
        # Per-utterance static features (length 1 for every sample,
        # e.g. CategoryDataReader speaker indices) stay length 1 so
        # merge_inputs can broadcast them across time — bucket-padding
        # them would mismatch the sequence features' bucket.
        if pad_to_bucket and max_len > 1:
            max_len = bucket_length(max_len, bucket_boundaries)
        if max_len > 1:
            max_len_overall = max(max_len_overall, max_len)
        # Trailing dims may differ per sample (e.g. attention matrices
        # with per-utterance phone counts): pad each to the batch max.
        trailing = tuple(
            max(f.shape[d] for f in feats)
            for d in range(1, feats[0].ndim))
        padded = np.zeros((len(feats), max_len) + trailing,
                          dtype=np.float32)
        for i, f in enumerate(feats):
            padded[(i, slice(0, len(f)))
                   + tuple(slice(0, s) for s in f.shape[1:])] = f
        if not batch_first:
            padded = np.moveaxis(padded, 0, 1)
        batch[key] = padded
        lengths[key] = lens
    # Masks: `_seq_mask` from the first feature (back-compat) plus a
    # per-feature mask `_seq_mask:<key>` so losses on features with a
    # different time base (e.g. frame-level targets next to phone-level
    # inputs) mask correctly.
    def make_mask(key):
        T = batch[key].shape[1 if batch_first else 0]
        mask = (np.arange(T)[None, :] < lengths[key][:, None])
        mask = mask[..., None].astype(np.float32)
        return mask if batch_first else np.moveaxis(mask, 0, 1)

    for key in keys:
        batch["_seq_mask:" + key] = make_mask(key)
    # The back-compat unqualified mask belongs to the LONGEST sequence
    # group, not whichever key happens to be first (a static
    # speaker-id feature listed first would otherwise hand every
    # seq_mask="_seq_mask" loss an all-ones (B, 1, 1) mask).
    seq_key = keys[0]
    for key in keys:
        if batch[key].shape[1 if batch_first else 0] == max_len_overall:
            seq_key = key
            break
    batch["_seq_mask"] = batch["_seq_mask:" + seq_key]
    batch["_lengths"] = lengths
    batch["_id_list"] = [s.get("_id_list") for s in samples]
    return batch


def batch_shape(batch):
    """Rows ``B``, padded length ``T`` and ``real_frames`` of a
    batch-first collated batch, read from its ``_seq_mask``; {} for a
    batch without one."""
    mask = batch.get("_seq_mask")
    if mask is None:
        return {}
    return {"B": int(mask.shape[0]), "T": int(mask.shape[1]),
            "real_frames": int((mask != 0).sum())}


def batch_decollate(batch, lengths=None, batch_first=True):
    """Batch dict -> list of per-sample dicts with padding stripped."""
    keys = [k for k in batch if not k.startswith("_")]
    if lengths is None:
        lengths = batch.get("_lengths")
    num = None
    for key in keys:
        arr = batch[key]
        num = arr.shape[0] if batch_first else arr.shape[1]
        break
    out = []
    for i in range(num):
        sample = {}
        for key in keys:
            arr = batch[key]
            row = arr[i] if batch_first else arr[:, i]
            if lengths is not None and key in lengths:
                row = row[:int(lengths[key][i])]
            sample[key] = np.asarray(row)
        if "_id_list" in batch:
            sample["_id_list"] = batch["_id_list"][i]
        out.append(sample)
    return out
