"""Parity of the port's training-slice host modules with the JAX package's:
normalisation loading, the question and WORLD readers, the dataset and
collate (identical arrays on the fixture corpus), the named losses and
the schedulers (the same numbers per type and per step), the hparams
defaults, and the config-JSON class-path loader.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.data import dataset as jax_dataset
from idiaptts_tpu.data import normalisation as jax_norm
from idiaptts_tpu.data.questions import QuestionLabelGen as JaxQuestions
from idiaptts_tpu.data.world_feat import WorldFeatLabelGen as JaxWorld
from idiaptts_tpu.hparams import ExtendedHParams as JaxHParams
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.models.losses import NamedLoss as JaxLoss
from idiaptts_tpu.train import schedulers as jax_sched
from idiaptts_torch.data import dataset as torch_dataset
from idiaptts_torch.data import normalisation as torch_norm
from idiaptts_torch.data.questions import QuestionLabelGen
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.train import schedulers as torch_sched


def _readers(pkg, fixtures_dir, num_questions, add_deltas=True):
    q_cls, w_cls = (JaxQuestions, JaxWorld) if pkg == "jax" \
        else (QuestionLabelGen, WorldFeatLabelGen)
    q = q_cls.Config(name="questions",
                     directory=os.path.join(fixtures_dir, "questions"),
                     num_questions=num_questions)
    w = w_cls.Config(name="cmp_features",
                     output_names=("acoustic_features",),
                     directory=os.path.join(fixtures_dir, "WORLD"),
                     add_deltas=add_deltas, num_coded_sps=20,
                     match_length="questions")
    q.match_length = ("acoustic_features",)
    return [q.create_reader(), w.create_reader()]


@pytest.mark.parametrize("add_deltas", [True, False])
def test_readers_and_collate_match_jax(fixtures_dir, id_list, num_questions,
                                       add_deltas):
    """The same samples, normalisation and collated batches, bit for
    bit."""
    jr = _readers("jax", fixtures_dir, num_questions, add_deltas)
    tr = _readers("torch", fixtures_dir, num_questions, add_deltas)
    for a, b in zip(jr, tr):
        # Without deltas the fixtures hold no per-stream std-dev files.
        assert (a.norm_params is None) == (b.norm_params is None)
        for x, y in zip(a.norm_params or (), b.norm_params or ()):
            np.testing.assert_array_equal(x, y)
    jds = jax_dataset.DatareadersDataset(id_list, jr, random_select=False)
    tds = torch_dataset.DatareadersDataset(id_list, tr, random_select=False)
    samples_j = [jds.get_id_name(i)[0] for i in id_list]
    samples_t = [tds.get_id_name(i)[0] for i in id_list]
    for sj, st in zip(samples_j, samples_t):
        assert sorted(sj) == sorted(st)
        for k in sj:
            np.testing.assert_array_equal(sj[k], st[k])
    bj = jax_dataset.collate_batch(samples_j[:4])
    bt = torch_dataset.collate_batch(samples_t[:4])
    assert sorted(bj) == sorted(bt)
    for k in bj:
        if k == "_lengths":
            for n in bj[k]:
                np.testing.assert_array_equal(bj[k][n], bt[k][n])
        else:
            np.testing.assert_array_equal(bj[k], bt[k])
    for dj, dt in zip(jax_dataset.batch_decollate(bj),
                      torch_dataset.batch_decollate(bt)):
        for k in dj:
            np.testing.assert_array_equal(dj[k], dt[k])


@pytest.mark.parametrize("length", [1, 128, 129, 4096, 5000])
def test_bucket_length_matches_jax(length):
    assert torch_dataset.bucket_length(length) \
        == jax_dataset.bucket_length(length)


@pytest.mark.parametrize("cls", ["MeanStdDevExtractor",
                                 "MeanCovarianceExtractor",
                                 "MinMaxExtractor"])
def test_normalisation_loads_what_jax_saves(tmp_path, cls):
    rs = np.random.RandomState(0)
    ext = getattr(jax_norm, cls)()
    ext.add_sample(rs.randn(50, 6))
    ext.add_sample(rs.randn(30, 6) + 1.0)
    ext.save(str(tmp_path / "x"))
    path = str(tmp_path / ("x-" + ext.file_name_appendix + ".npz"))
    ref = getattr(jax_norm, cls).load(path)
    got = getattr(torch_norm, cls).load(path)
    feat = rs.randn(7, 6).astype(np.float32)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    np.testing.assert_array_equal(
        getattr(jax_norm, cls)._normalise(feat, *ref),
        getattr(torch_norm, cls)._normalise(feat, *got))
    np.testing.assert_array_equal(
        getattr(jax_norm, cls)._denormalise(feat, *ref),
        getattr(torch_norm, cls)._denormalise(feat, *got))


def test_question_generation_raises_naming_the_roadmap(fixtures_dir,
                                                     question_file):
    """Question generation (``tests/unit/test_torch_questions.py`` holds
    it to the JAX package) runs on a fixture label; WORLD feature
    generation, which raised here until it was ported, extracts one
    fixture wav as the JAX package does (features within the bounds of
    ``tests/unit/test_torch_feature_gen.py``: coded spectrum 0.2, lf0
    1e-4, bap 0.05; the voicing equal)."""
    label_dir = os.path.join(fixtures_dir, "labels", "label_state_align")
    vmin, vmax = QuestionLabelGen.gen_data(label_dir, question_file,
                                           id_list=["gen-0001"])
    ref_min, ref_max = JaxQuestions.gen_data(label_dir, question_file,
                                             id_list=["gen-0001"])
    np.testing.assert_array_equal(vmin, ref_min)
    np.testing.assert_array_equal(vmax, ref_max)
    wav_dir = os.path.join(fixtures_dir, "database", "wav")
    labels, _ = WorldFeatLabelGen(num_coded_sps=20, device="cpu").gen_data(
        wav_dir, id_list=["gen-0001"], return_dict=True)
    ref, _ = JaxWorld(num_coded_sps=20).gen_data(
        wav_dir, id_list=["gen-0001"], return_dict=True)
    got, want = labels["gen-0001"], ref["gen-0001"]
    assert got.shape == want.shape == (229, 23)
    assert np.abs(got[:, :20] - want[:, :20]).max() < 0.2
    np.testing.assert_allclose(got[:, 20], want[:, 20], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[:, 21], want[:, 21])
    assert np.abs(got[:, 22] - want[:, 22]).max() < 0.05


def _loss_inputs(type_):
    rs = np.random.RandomState(1)
    B, T, C = 3, 11, 6
    pred = rs.randn(B, T, C).astype(np.float32)
    target = rs.randn(B, T, C).astype(np.float32)
    kwargs = {}
    if type_ in ("CrossEntropyLoss", "UnWeightedAccuracy"):
        target = rs.randint(0, C, (B, T, 1)).astype(np.float32)
    elif type_ == "BCELoss":
        pred = 1 / (1 + np.exp(-pred))
        target = (target > 0).astype(np.float32)
    elif type_ == "L1WeightedVUVMSELoss":
        target[..., 1] = (target[..., 1] > 0)
        pred, target = pred[..., :2], target[..., :2]
    elif type_ == "OneHotCrossEntropyLoss":
        target = np.eye(C, dtype=np.float32)[rs.randint(0, C, (B, T))]
        kwargs = {"shift": 1}
    elif type_ == "DiscretizedMixtureLogisticLoss":
        pred = rs.randn(B, T, 9).astype(np.float32)
        target = np.tanh(rs.randn(B, T, 1)).astype(np.float32)
        target[0, 0], target[0, 1] = -1.0, 1.0
    elif type_ == "WMSELoss":
        kwargs = {"weighted_indices": [1, 4], "weight": 3.0}
    elif type_ in ("WeightedNonzeroMSELoss", "WeightedNonzeroWMSEAtomLoss"):
        target[rs.rand(B, T, C) < 0.5] = 0.0
    elif type_ == "AtomLoss":
        T = 40
        pred = rs.randn(B, T, 5).astype(np.float32)
        target = rs.randn(B, T, 5).astype(np.float32)
        kwargs = {"kernel_length": 20}
    lengths = np.array([pred.shape[1], 7, 4])
    mask = (np.arange(pred.shape[1])[None] < lengths[:, None])[..., None]
    data = {"pred": pred, "target": target,
            "_seq_mask": mask.astype(np.float32),
            "vae_mu": rs.randn(B, 4).astype(np.float32),
            "vae_logvar": rs.randn(B, 4).astype(np.float32) * 0.1}
    return data, kwargs


LOSS_TYPES = ["MSELoss", "L1Loss", "CrossEntropyLoss", "BCELoss", "WMSELoss",
              "L1WeightedVUVMSELoss", "WeightedNonzeroMSELoss",
              "OneHotCrossEntropyLoss", "DiscretizedMixtureLogisticLoss",
              "UnWeightedAccuracy", "AtomLoss",
              "WeightedNonzeroWMSEAtomLoss"]


@pytest.mark.parametrize("type_", LOSS_TYPES)
def test_loss_matches_jax(type_):
    """Every loss type, masked, under mean_per_frame; float32 sums in
    another order (rtol 1e-5)."""
    data, kwargs = _loss_inputs(type_)
    cfg = ("l", type_, ("pred", "target"))
    ref = JaxLoss(JaxLoss.Config(*cfg, seq_mask="_seq_mask", **kwargs))(
        {k: jnp.asarray(v) for k, v in data.items()}, step=3)
    got = NamedLoss(NamedLoss.Config(*cfg, seq_mask="_seq_mask", **kwargs))(
        {k: torch.from_numpy(v) for k, v in data.items()}, step=3)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean_per_frame", "mean_per_sample",
                                       "mean", "sum", "none"])
@pytest.mark.parametrize("masked", [True, False])
def test_loss_reductions_match_jax(reduction, masked):
    data, _ = _loss_inputs("MSELoss")
    kw = dict(seq_mask="_seq_mask" if masked else None, reduction=reduction,
              loss_weight=0.5, start_step=2)
    ref = JaxLoss(JaxLoss.Config("l", "MSELoss", ("pred", "target"), **kw))
    got = NamedLoss(NamedLoss.Config("l", "MSELoss", ("pred", "target"),
                                     **kw))
    for step in (1, 2):
        r = np.asarray(ref({k: jnp.asarray(v) for k, v in data.items()},
                           step=step))
        g = got({k: torch.from_numpy(v) for k, v in data.items()},
                step=step).numpy()
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7)


def test_vae_kld_annealing_matches_jax():
    data, _ = _loss_inputs("MSELoss")
    kw = dict(annealing_steps=10, annealing_start=2)
    ref = JaxLoss(JaxLoss.Config("k", "VAEKLDLoss", ("pred",), **kw))
    got = NamedLoss(NamedLoss.Config("k", "VAEKLDLoss", ("pred",), **kw))
    for step in (0, 5, 20):
        np.testing.assert_allclose(
            float(got({k: torch.from_numpy(v) for k, v in data.items()},
                      step=step)),
            float(ref({k: jnp.asarray(v) for k, v in data.items()},
                      step=step)), rtol=1e-5, atol=1e-7)


SCHEDULERS = [("default", {}), ("Exponential", {"gamma": 0.9}),
              ("ExtendedExponential", {"gamma": 0.5, "warmup_steps": 3,
                                       "decay_steps": 2, "min_lr": 1e-4}),
              ("Noam", {"warmup_steps": 5}),
              ("Plateau", {"factor": 0.5, "patience": 1})]


@pytest.mark.parametrize("name,args", SCHEDULERS)
def test_scheduler_matches_jax(name, args):
    """The same learning rate at every step, epoch and metric."""
    ref = jax_sched.create_scheduler(name, 0.01, dict(args))
    got = torch_sched.create_scheduler(name, 0.01, dict(args))
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7]
    for step in range(1, 9):
        ref.on_epoch(step)
        got.on_epoch(step)
        ref.on_metric(metrics[step - 1])
        got.on_metric(metrics[step - 1])
        assert got.lr(step) == ref.lr(step)
    assert got.state_dict() == ref.state_dict()


def test_hparams_defaults_match_jax_but_for_the_device_keys():
    ref = JaxHParams.create_hparams().values()
    got = ExtendedHParams.create_hparams(
        "learning_rate=0.01,epochs=3").values()
    # The mesh keys load with the JAX defaults (data parallelism).
    mesh = {"model_parallel", "use_shard_map", "mesh_shape", "data_axis"}
    assert set(ref) - set(got) == set()
    assert set(got) - set(ref) == {"device", "bf16_residuals"}
    # bf16_residuals None: the JAX handler's rule (bf16 residuals above
    # 32 batch rows), kept by the residual-precision trajectory test.
    assert got["device"] == "cuda" and got["bf16_residuals"] is None
    assert got["learning_rate"] == 0.01 and got["epochs"] == 3
    for k in set(ref) - {"learning_rate", "epochs"}:
        assert got[k] == ref[k], k
    assert all(got[k] == ref[k] for k in mesh)


def test_jax_config_json_loads_as_port_config():
    """A config.json written by the JAX package builds the port's model;
    a class path that is no model config of the JAX package raises."""
    cfg_j = jax_rnn.convert_legacy_string(
        "RNNDYN-1_RELU_16-1_BiLSTM_128-1_FC_5", 7)
    cfg_j.input_names = ("questions",)
    cfg_j.output_names = ("pred",)
    cfg = ModelConfig.from_json(cfg_j.to_json())
    assert isinstance(cfg, torch_rnn.RNNDyn.Config)
    assert cfg.input_names == ("questions",)
    assert [lc.layer_type for lc in cfg.layer_configs] == \
        ["Linear", "LSTM", "Linear"]
    model = cfg.create_model()
    out = model({"questions": torch.zeros(2, 4, 7)})["pred"]
    assert out.shape == (2, 4, 5)
    # The port's own JSON round-trips too.
    again = ModelConfig.from_json(cfg.to_json())
    assert type(again) is torch_rnn.RNNDyn.Config
    # The VTLN layer's JAX config builds the port's class now; a class
    # path that is no model config of the JAX package is refused.
    from idiaptts_torch.models.vtln import AllPassWarpLayer
    warp = ModelConfig.from_json(json.dumps(
        {"__class__": "idiaptts_tpu.models.vtln:AllPassWarpLayer.Config",
         "input_names": ["x"], "output_names": ["y"],
         "warp_matrix_size": 4, "alpha_ranges": [0.2],
         "alpha_input_names": ["spk"], "mean": None, "std_dev": None,
         "grad_lambda": 200.0}))
    assert type(warp) is AllPassWarpLayer.Config
    out = warp.create_model()({"x": torch.zeros(2, 3, 4),
                               "spk": torch.zeros(2, 1)})
    assert out["y"].shape == (2, 3, 4) and out["alphas"].shape == (2, 3, 1)
    with pytest.raises(NotImplementedError, match="Unknown model config"):
        ModelConfig.from_json(json.dumps(
            {"__class__": "idiaptts_tpu.models.vtln:NoSuchLayer.Config",
             "input_names": ["x"]}))
