"""Objective metrics with accumulation and worst-case logging: the port's
copy of ``idiaptts_tpu/synth/metrics.py`` (numpy and scipy only).

Capability parity with ``idiaptts/src/Metrics.py`` (:17-210): MCD(_k),
F0-RMSE, GPE, FFE, VDE, BAP distortion, Dur RMSE / Pearson; accumulate
per-utterance + worst-case tracking.  The nnmnkwii ``melcd`` dependency
is replaced by the closed form ``mean ||a-b||_2 * 10*sqrt(2)/ln(10)``.
"""

import logging
import math

import numpy as np
import scipy.stats

logger = logging.getLogger(__name__)

_MCD_CONST = 10.0 / np.log(10) * np.sqrt(2.0)


def melcd(a, b):
    """Mel-cepstral distortion in dB (nnmnkwii.metrics.melcd role)."""
    diff = np.asarray(a) - np.asarray(b)
    return float(np.mean(np.sqrt(np.sum(diff ** 2, axis=-1)))
                 * _MCD_CONST)


class Metrics:
    MCD = "MCD"
    F0_RMSE = "F0 RMSE"
    GPE = "GPE"
    FFE = "FFE"
    VDE = "VDE"
    BAP_distortion = "BAP distortion"
    Dur_RMSE = "Dur RMSE"
    Dur_pearson = "Dur pearson"

    _metric_formats = {MCD: "{:4.2f}dB", F0_RMSE: "{:4.2f}Hz",
                       GPE: "{:2.2%}", FFE: "{:2.2%}", VDE: "{:2.2%}",
                       BAP_distortion: "{:4.2f}dB",
                       Dur_RMSE: "{:4.2f}", Dur_pearson: "{}"}

    def __init__(self, metric_identifiers):
        self.metrics = list(metric_identifiers)
        n = len(self.metrics)
        self.cum_values = [0] * n
        self.max_values = [None] * n
        self.max_value_ids = ["None"] * n
        self.cum_counts = [0] * n

    @staticmethod
    def get_metrics(metric_names, org_coded_sp=None, org_lf0=None,
                    org_vuv=None, org_bap=None, output_coded_sp=None,
                    output_lf0=None, output_vuv=None, output_bap=None,
                    org_dur=None, output_dur=None):
        values = []
        for name in metric_names:
            if name == Metrics.MCD:
                value = Metrics.mcd_k(org_coded_sp, output_coded_sp)
            elif name.startswith(Metrics.MCD):
                k = int(name.split("_")[1])
                value = Metrics.mcd_k(org_coded_sp, output_coded_sp, k=k)
            elif name == Metrics.F0_RMSE:
                value = Metrics.f0_rmse(org_lf0, org_vuv, output_lf0)
            elif name == Metrics.GPE:
                value = Metrics.gross_pitch_error(org_lf0, org_vuv,
                                                  output_lf0, output_vuv)
            elif name == Metrics.FFE:
                value = Metrics.f0_frame_error(org_lf0, org_vuv,
                                               output_lf0, output_vuv)
            elif name == Metrics.VDE:
                value = Metrics.voicing_decision_error(org_vuv,
                                                       output_vuv)
            elif name == Metrics.BAP_distortion:
                value = Metrics.aperiodicity_distortion(org_bap,
                                                        output_bap)
            elif name == Metrics.Dur_RMSE:
                value = Metrics.rmse(org_dur, output_dur)
            elif name == Metrics.Dur_pearson:
                value = Metrics.pearson(org_dur, output_dur)
            else:
                raise NotImplementedError("Unknown metric " + name)
            values.append((name, value))
        return values

    @staticmethod
    def mcd_k(org_cep, output_cep, k=None, start_bin=1):
        org = org_cep[:len(output_cep)]
        end = k if k is not None else None
        return melcd(output_cep[:, start_bin:end], org[:, start_bin:end])

    @staticmethod
    def f0_rmse(org_lf0, org_vuv, output_lf0):
        org_f0 = np.exp(np.squeeze(org_lf0))
        output_f0 = np.exp(np.squeeze(output_lf0))
        org_f0 = org_f0[:len(output_f0)]
        vuv = np.squeeze(org_vuv)[:len(output_f0)]
        mse = (org_f0 - output_f0) ** 2
        return math.sqrt((mse * vuv).sum() / max(vuv.sum(), 1))

    @staticmethod
    def gross_pitch_error(org_lf0, org_vuv, output_lf0, output_vuv):
        org_lf0 = np.squeeze(org_lf0)[:len(output_lf0)]
        org_vuv = np.squeeze(org_vuv)[:len(output_lf0)]
        output_lf0 = np.squeeze(output_lf0)
        output_vuv = np.squeeze(output_vuv)
        errors = np.abs(org_lf0 - output_lf0) > 0.2 * org_lf0
        both = org_vuv * output_vuv
        return (errors * both).sum() / max(both.sum(), 1)

    @staticmethod
    def f0_frame_error(org_lf0, org_vuv, output_lf0, output_vuv):
        org_lf0 = np.squeeze(org_lf0)[:len(output_lf0)]
        org_vuv = np.squeeze(org_vuv)[:len(output_lf0)]
        output_lf0 = np.squeeze(output_lf0)
        output_vuv = np.squeeze(output_vuv)
        errors = np.abs(org_lf0 - output_lf0) > 0.2 * org_lf0
        both = org_vuv * output_vuv
        vde = Metrics.voicing_decision_error(org_vuv, output_vuv)
        return (errors * both).sum() / len(output_vuv) + vde

    @staticmethod
    def voicing_decision_error(org_vuv, output_vuv):
        org_vuv = np.squeeze(org_vuv)[:len(np.squeeze(output_vuv))]
        return (org_vuv != np.squeeze(output_vuv)).sum() \
            / len(np.squeeze(output_vuv))

    @staticmethod
    def aperiodicity_distortion(org_bap, output_bap):
        org_bap = org_bap[:len(output_bap)]
        if output_bap.ndim > 1 and output_bap.shape[1] > 1:
            return Metrics.mcd_k(org_bap, output_bap)
        return math.sqrt(((org_bap - output_bap) ** 2).mean()) \
            * _MCD_CONST

    @staticmethod
    def rmse(org, output, axis=None):
        mse = (np.asarray(org) - np.asarray(output)) ** 2
        return np.sqrt(mse.sum(axis=axis) / len(mse))

    @staticmethod
    def pearson(org, output):
        return np.array([scipy.stats.pearsonr(org[:, i], output[:, i])[0]
                         for i in range(org.shape[1])])

    def accumulate(self, id_name, current_metrics):
        for i, (name, value) in enumerate(current_metrics):
            if np.isnan(value).any():
                logger.error("Computed NaN for %s for %s.", name, id_name)
                continue
            if self.max_values[i] is None \
                    or np.array(value > self.max_values[i]).all():
                self.max_values[i] = value
                self.max_value_ids[i] = id_name
            self.cum_values[i] += value
            self.cum_counts[i] += 1

    def get_cum_values(self):
        return [v / c if c else np.nan
                for v, c in zip(self.cum_values, self.cum_counts)]

    def log(self):
        cum = self.get_cum_values()
        parts = []
        for i, name in enumerate(self.metrics):
            base = "MCD" if name.startswith("MCD_") else name
            fmt = self._metric_formats.get(base, "{}")
            parts.append(("{} " + fmt).format(name, cum[i]))
            logger.info(("Worst {}: {} " + fmt).format(
                name, self.max_value_ids[i], self.max_values[i]))
        logger.info("Benchmark score: %s", ", ".join(parts))
