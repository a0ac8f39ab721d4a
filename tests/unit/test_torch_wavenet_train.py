"""WaveNet vocoder training in the port against the JAX package:
``RawWaveformLabelGen`` on the fixture wavs, the teacher-forced logits,
the masked cross-entropy and its gradients (4 layers at the production
widths), one handler step of ``WaveNetVocoderTrainer`` against the JAX
trainer's from the same weights and batch, and the round trip from
``save_for_vocoding`` to ``WaveNetVocoder.load`` and generation.

Tolerances, measured: the reader exactly (numpy and scipy on both
sides).  The network's bf16 layers round in other places than XLA's CPU
bf16 dots (ROADMAP fault 3.2): logits within 2e-2 of their largest
magnitude (measured 5.9e-3 in test_torch_wavenet.py), the loss within
1e-4 relative (measured 1.5e-6).  JAX's backward carries bf16
cotangents through the bf16 layers where the port's autograd carries
float32 ones, so each gradient tensor agrees in direction (cosine
similarity at least 0.99, measured at least 0.9931) and in norm within
15% (measured 12%); after one Adam step the parameters agree within
2 lr.
"""

import os

import jax
import numpy as np
import pytest
import torch

from idiaptts_tpu.data import audio_gen as jax_audio_gen
from idiaptts_tpu.data.dataset import collate_batch
from idiaptts_tpu.models import wavenet as jax_wavenet
from idiaptts_tpu.models.losses import NamedLoss as JaxLoss
from idiaptts_tpu.train import wavenet_trainer as jax_tr
from idiaptts_torch.data import audio_gen as torch_audio_gen
from idiaptts_torch.models import convert
from idiaptts_torch.models import wavenet as torch_wavenet
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.train import wavenet_trainer as torch_tr

LAYERS = 4
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("wav_dir,fs,trim", [
    ("wav", 16000, None), ("wav48", 16000, -40.0), ("wav", 8000, None)])
def test_raw_waveform_reader_matches_jax(fixtures_dir, wav_dir, fs, trim):
    """Load (resampled, silence trimmed), mu-law quantise and invert:
    identical to the JAX reader."""
    directory = os.path.join(fixtures_dir, "database", wav_dir)
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(directory)
                 if f.endswith(".wav"))[:3]
    readers = [mod.RawWaveformLabelGen.Config(
        name="target_quantised", dir_audio=directory,
        frame_rate_output_hz=fs, silence_threshold_db=trim).create_reader()
        for mod in (jax_audio_gen, torch_audio_gen)]
    for id_name in ids:
        ref, got = (r[id_name]["target_quantised"] for r in readers)
        np.testing.assert_array_equal(got, ref)
        assert got.min() >= 0 and got.max() <= 255
        np.testing.assert_array_equal(readers[1].postprocess_sample(got),
                                      readers[0].postprocess_sample(ref))
        path = os.path.join(directory, id_name + ".wav")
        np.testing.assert_array_equal(
            torch_audio_gen.RawWaveformLabelGen.load_sample(path, fs),
            jax_audio_gen.RawWaveformLabelGen.load_sample(path, fs))


def _configs(cond_channels=23):
    kwargs = dict(input_names=("cond_features",),
                  output_names=("pred_logits",),
                  target_name="target_quantised", num_layers=LAYERS,
                  num_stacks=2)
    return (jax_wavenet.WaveNetWrapper.Config(**kwargs),
            torch_wavenet.WaveNetWrapper.Config(cond_channels=cond_channels,
                                                **kwargs))


def test_teacher_forced_logits_loss_and_gradients_match_jax():
    """The masked CE of the teacher-forced logits, and its gradients,
    from the same weights (a padded second row masked out)."""
    rng = np.random.RandomState(0)
    B, T, C = 2, 120, 23
    data = {"cond_features": (rng.randn(B, T, C) * 0.3).astype(np.float32),
            "target_quantised": rng.randint(0, 256, (B, T, 1)).astype(
                np.float32),
            "_seq_mask": np.ones((B, T, 1), np.float32)}
    data["_seq_mask"][1, 90:] = 0.0
    cfg_j, cfg_t = _configs()
    jm = cfg_j.create_model()
    variables = jm.init(jax.random.PRNGKey(0), data, training=True)
    model = cfg_t.create_model()
    convert.load_flax_params(model, _to_np(variables))
    ce_j = JaxLoss.Config("ce", "CrossEntropyLoss",
                          ("pred_logits", "target_quantised"),
                          seq_mask="_seq_mask", reduction="mean").create_loss()
    ce_t = NamedLoss.Config("ce", "CrossEntropyLoss",
                            ("pred_logits", "target_quantised"),
                            seq_mask="_seq_mask",
                            reduction="mean").create_loss()

    def loss(v):
        out = jm.apply(v, data, training=True)
        return ce_j(out), out["pred_logits"]

    (loss_j, logits_j), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables)
    out = model({k: torch.from_numpy(v) for k, v in data.items()},
                training=True)
    logits_j = np.asarray(logits_j)
    assert np.abs(out["pred_logits"].detach().numpy() - logits_j).max() \
        <= 2e-2 * np.abs(logits_j).max()
    loss_t = ce_t(out)
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-4)
    loss_t.backward()
    ref_g = convert.flax_to_state_dict(_to_np(grads))
    for name, p in model.named_parameters():
        ref = ref_g[name].numpy().ravel()
        if p.grad is None:      # the last block's unused residual output
            assert not ref.any(), name
            continue
        got = p.grad.numpy().ravel()
        norm = np.linalg.norm(ref)
        assert got @ ref >= 0.99 * np.linalg.norm(got) * norm, name
        assert abs(np.linalg.norm(got) - norm) <= 0.15 * norm, name


def _trainer(mod, fixtures_dir, id_list, tmp_path, port):
    cls = mod.WaveNetVocoderTrainer
    hp = cls.create_hparams()
    hp.out_dir = str(tmp_path)
    hp.model_name = "wavenet"
    hp.batch_size_train = 2
    hp.learning_rate = LR
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.max_input_train_sec = 0.1
    hp.num_coded_sps_cond = 20
    hp.num_coded_sps = 20
    if port:
        hp.device = "cpu"
    trainer = cls(hp, list(id_list),
                  dir_world_features=os.path.join(fixtures_dir, "WORLD"),
                  dir_audio=os.path.join(fixtures_dir, "database", "wav"))
    return trainer, hp


def test_wavenet_trainer_step_and_vocoder_round_trip(fixtures_dir, id_list,
                                                     tmp_path):
    """One handler step of the port's trainer against the JAX trainer's
    on the same cropped batch (conditioning upsampled to the sample
    rate, mu-law targets, Noam schedule), then ``save_for_vocoding`` ->
    ``WaveNetVocoder.load`` gives the trained parameters back and
    generates from them."""
    jt, hp_j = _trainer(jax_tr, fixtures_dir, id_list, tmp_path / "jax",
                        False)
    tt, hp_t = _trainer(torch_tr, fixtures_dir, id_list, tmp_path / "port",
                        True)
    cfg_j, cfg_t = _configs(cond_channels=23)
    jt.init(hp_j, model_config=cfg_j)
    tt.init(hp_t, model_config=cfg_t)
    assert tt.model_handler.scheduler.lr(1) == pytest.approx(
        jt.model_handler.scheduler.lr(1))
    convert.load_flax_params(tt.model_handler.model,
                             _to_np(jt.model_handler.params))
    ids = tt.id_list_train[:2]
    batch = collate_batch([tt.dataset_train.get_id_name(i)[0] for i in ids])
    assert set(batch["_lengths"]["cond_features"]) == \
        set(batch["_lengths"]["target_quantised"]) == {1600}
    loss_j, _ = jt.model_handler.process_batches([batch])
    loss_t, _ = tt.model_handler.process_batches([batch])
    assert loss_t == pytest.approx(loss_j, rel=2e-3)
    ref = convert.flax_to_state_dict(_to_np(jt.model_handler.params))
    got = tt.model_handler.model.state_dict()
    for key, value in ref.items():
        assert (got[key] - value).abs().max().item() <= 2 * LR + 1e-6, key
    # The default model takes the conditioning width from the data.
    assert tt.default_model_config(hp_t, 23).cond_channels == 23

    bundle = str(tmp_path / "voc" / "wavenet_voc")
    tt.save_for_vocoding(hp_t, bundle)
    vocoder = torch_wavenet.WaveNetVocoder.load(
        os.path.join(bundle, "nn"), device="cpu")
    for key, value in vocoder.model.state_dict().items():
        assert torch.equal(value, got[key]), key
    norms = [getattr(t.datareaders["cond_features"], "norm_params", None)
             for t in (jt, tt)]
    assert (norms[0] is None) == (norms[1] is None)
    assert os.path.isfile(bundle + "_norm_params.npy") == \
        (norms[1] is not None)
    sample, _ = tt.dataset_val.get_id_name(tt.id_list_val[0])
    wav = vocoder.generate(sample["cond_features"][:200])
    assert wav.shape == (200,) and np.all(np.abs(wav) <= 1.0)
