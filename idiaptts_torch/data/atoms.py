"""GCR atom labels and LF0 reconstruction: the port of
``idiaptts_tpu/data/atoms.py`` (numpy on the host, as there).

- :class:`GammaAtom`: one L2-normalised gamma kernel at a position.
- :class:`AtomLabelGen`: reads wcad atom labels (``.atoms``, raw
  float32 (T, |thetas|, 2) amp/theta spikes, or an npz ``atoms``) and
  ``.phrase`` curves; ``preprocess_sample`` keeps the normalised
  amplitudes, ``postprocess_sample`` denormalises, keeps the local
  extrema and restores the thetas; the conversions between labels,
  atoms and LF0.
- :class:`AtomVUVDistPosLabelGen`: the amplitudes plus a position flag
  smeared by a normal distribution (``surround_with_norm_dist``) and the
  WORLD vuv column.
"""

import math
import os

import numpy as np

from idiaptts_torch.data.normalisation import MeanStdDevExtractor
from idiaptts_torch.data.reader import LabelGen, NpzDataReader
from idiaptts_torch.ops.interpolation import surround_with_norm_dist


class GammaAtom:
    """One gamma-kernel intonation atom."""

    def __init__(self, k, theta, frame_rate, amp=1.0, position=0):
        self.k = k
        self.theta = theta
        self.frame_rate = frame_rate
        self.amp = amp
        self.position = position

    def curve(self, length):
        """L2-normalised gamma kernel sampled at the frame rate."""
        t = np.arange(1, length + 1) / self.frame_rate
        k, theta = self.k, self.theta
        g = (t ** (k - 1) * np.exp(-t / theta)
             / (theta ** k * math.gamma(k)))
        norm = np.linalg.norm(g)
        if norm > 0:
            g = g / norm
        return self.amp * g

    def get_padded_curve(self, num_frames, curve_length=None):
        length = curve_length or num_frames
        curve = self.curve(length)
        out = np.zeros(num_frames)
        end = min(num_frames, self.position + length)
        out[self.position:end] = curve[:end - self.position]
        return out


class AtomLabelGen(NpzDataReader, LabelGen):
    """Reads wcad atom labels: (T, |thetas|, 2) with (amp, theta)."""

    ext_atoms = ".atoms"
    ext_phrase = ".phrase"

    class Config(NpzDataReader.Config):
        def __init__(self, *args, thetas=None, k=6, frame_size_ms=5,
                     **kwargs):
            kwargs.setdefault("norm_type",
                              NpzDataReader.Config.NormType.MEAN_STDDEV)
            super().__init__(*args, **kwargs)
            self.thetas = tuple(thetas or ())
            self.k = k
            self.frame_size_ms = frame_size_ms

        def create_reader(self):
            reader = AtomLabelGen(self)
            try:
                reader.get_normalisation_params()
            except (AssertionError, FileNotFoundError):
                pass
            return reader

    def __init__(self, config):
        super().__init__(config)
        self.theta_interval = np.asarray(config.thetas, np.float32)
        self.num_thetas = len(self.theta_interval)
        self.k = config.k
        self.frame_size_ms = config.frame_size_ms

    def load(self, id_name):
        id_name = os.path.splitext(os.path.basename(id_name))[0]
        for directory in self.directory:
            path = os.path.join(directory, id_name + self.ext_atoms)
            if os.path.isfile(path):
                arr = np.fromfile(path, dtype=np.float32)
                return arr.reshape(-1, self.num_thetas, 2)
            npz = os.path.join(directory, id_name + ".npz")
            if os.path.isfile(npz):
                return np.load(npz)["atoms"].astype(np.float32)
        raise FileNotFoundError(id_name)

    def load_phrase(self, id_name):
        id_name = os.path.splitext(os.path.basename(id_name))[0]
        for directory in self.directory:
            path = os.path.join(directory, id_name + self.ext_phrase)
            if os.path.isfile(path):
                return np.fromfile(path, dtype=np.float32)[:, None]
        raise FileNotFoundError(id_name)

    def preprocess_sample(self, features, feature_idx=0):
        """Keep only the amplitudes (theta implicit per column),
        normalised."""
        amps = np.asarray(features)[:, :, 0]
        if self.normaliser is not None and self.norm_params is not None:
            mean, scale = self.norm_params
            amps = (amps - np.asarray(mean)[..., :1]) \
                / np.asarray(scale)[..., :1]
        return amps.astype(np.float32)

    def postprocess_sample(self, features, feature_idx=0,
                           identify_peaks=True, peak_range=100):
        amps = np.asarray(features)
        if self.normaliser is not None and self.norm_params is not None:
            mean, scale = self.norm_params
            amps = amps * np.asarray(scale)[..., :1] \
                + np.asarray(mean)[..., :1]
        if identify_peaks:
            amps = self.identify_peaks(amps, peak_range)
        thetas = np.tile(self.theta_interval, (len(amps), 1))
        thetas = np.where(amps == 0, 0.0, thetas)
        return np.stack([amps, thetas], axis=2)

    @staticmethod
    def identify_peaks(label, peak_range=60):
        """Keep only local extrema per theta track within
        ``peak_range``."""
        out = np.zeros_like(label)
        half = max(1, peak_range // 2)
        for theta_idx in range(label.shape[1]):
            track = label[:, theta_idx]
            for t in range(len(track)):
                lo, hi = max(0, t - half), min(len(track), t + half + 1)
                window = track[lo:hi]
                if track[t] != 0 and (
                        track[t] == window.max() and track[t] > 0
                        or track[t] == window.min() and track[t] < 0):
                    out[t, theta_idx] = track[t]
        return out

    def get_normalisation_params(self, dir_out=None, file_name=None):
        directory = dir_out or self.directory[0]
        prefix = "" if not file_name else file_name + "-"
        base = os.path.join(directory, prefix
                            + MeanStdDevExtractor.file_name_appendix)
        for cand in (base + ".npz", base + ".bin"):
            if os.path.isfile(cand):
                mean, std = MeanStdDevExtractor.load(cand)
                self.norm_params = (mean, std)
                return self.norm_params
        # Default: atoms are sparse spikes around 0; unit scaling.
        self.norm_params = (np.zeros(1, np.float32),
                            np.ones(1, np.float32))
        return self.norm_params

    # -- conversions ------------------------------------------------------
    @staticmethod
    def labels_to_atoms(np_labels, k=6, frame_size=5, amp_threshold=0.3):
        atoms = []
        frame_rate = int(1000 / frame_size)
        if np_labels.ndim > 2:
            for idx, frame in enumerate(np_labels):
                for amp, theta in frame:
                    if abs(amp) >= amp_threshold:
                        atoms.append(GammaAtom(k, max(0.005, theta),
                                               frame_rate, amp, idx))
        else:
            for idx, (amp, theta) in enumerate(np_labels):
                if abs(amp) >= amp_threshold:
                    atoms.append(GammaAtom(k, max(0.005, theta),
                                           frame_rate, amp, idx))
        return atoms

    @staticmethod
    def atoms_to_lf0(atoms, num_frames):
        reconstruction = np.zeros(num_frames)
        for atom in atoms:
            reconstruction += atom.get_padded_curve(num_frames)
        return reconstruction

    @staticmethod
    def labels_to_lf0(labels, k=6, frame_size=5, amp_threshold=0.3):
        return AtomLabelGen.atoms_to_lf0(
            AtomLabelGen.labels_to_atoms(labels, k, frame_size,
                                         amp_threshold), len(labels))

    @staticmethod
    def atoms_to_labels(atom_list, thetas, num_frames, label_dim=2):
        thetas = np.asarray(thetas)
        labels = np.zeros((num_frames, len(thetas), label_dim),
                          np.float32)
        for atom in atom_list:
            idx = AtomLabelGen.theta_to_index(atom.theta, thetas)
            labels[atom.position, idx] += [atom.amp, atom.theta]
        return labels

    @staticmethod
    def theta_to_index(theta, thetas):
        return int(np.argmin(np.abs(np.asarray(thetas) - theta)))


class AtomVUVDistPosLabelGen(AtomLabelGen):
    """Atoms + VUV flag + gaussian position-distribution smearing.
    Output of ``preprocess_sample``: [amps(|thetas|), pos_flag], and
    ``__getitem__`` appends the vuv column when ``dir_world`` is set."""

    class Config(AtomLabelGen.Config):
        def __init__(self, *args, dist_window_size=51, dir_world=None,
                     **kwargs):
            super().__init__(*args, **kwargs)
            self.dist_window_size = dist_window_size
            self.dir_world = dir_world

        def create_reader(self):
            reader = AtomVUVDistPosLabelGen(self)
            try:
                reader.get_normalisation_params()
            except (AssertionError, FileNotFoundError):
                pass
            return reader

    def __init__(self, config):
        super().__init__(config)
        self.dist_window_size = config.dist_window_size
        self.dir_world = config.dir_world

    def load_vuv(self, id_name):
        from idiaptts_torch.data.world_feat import WorldFeatLabelGen
        sample = WorldFeatLabelGen.load_sample(
            id_name, self.dir_world, add_deltas=False,
            load_sp=False, load_lf0=False, load_bap=False)
        return sample

    def preprocess_sample(self, features, feature_idx=0):
        amps = super().preprocess_sample(features, feature_idx)
        pos_flag = surround_with_norm_dist(
            (np.abs(amps) > 1e-6).any(axis=1, keepdims=True)
            .astype(np.float32),
            window_size=self.dist_window_size)
        return np.concatenate([amps, pos_flag], axis=1)

    def __getitem__(self, id_name):
        out = super().__getitem__(id_name)
        if self.dir_world is not None:
            vuv = self.load_vuv(id_name)
            key = self.output_names[0]
            feats = out[key]
            n = min(len(feats), len(vuv))
            out[key] = np.concatenate([feats[:n], vuv[:n]], axis=1)
        return out
