"""The GCR atom intonation family of the port against the JAX package:
``data/atoms.py`` and ``data/wcad.py`` (numpy on both sides: exact),
the IIR filter banks forward and backward, ``NeuralFilters`` and
``PhraseNeuralFilters`` on converted weights, one handler step of each
atom trainer against the JAX trainer's, and the weight adoption between
trainers.

Tolerances, measured at these sizes:

- the filter banks (float32 step loops over T=60): the scans agree bit
  for bit given the same coefficients (the port repeats XLA's fused
  multiply-adds); the output gains' polynomial nearly cancels, so XLA's
  ``exp``, one ulp from PyTorch's in about 6% of arguments, moves a
  filter's gain by up to 6.2e-4 relative (measured): outputs and
  gradients within 1e-3 of their magnitude;
- the neural-filter models on a bf16 rnn_dyn atom model: as the filter
  banks (the atom model's bf16 outputs agree to float32 rounding);
- one trainer step (Adam): losses within 1e-4 relative, parameters
  within 2 lr (Adam's first step moves each weight by about lr; a
  near-zero gradient's sign may differ).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.data import atoms as jax_atoms
from idiaptts_tpu.data import wcad as jax_wcad
from idiaptts_tpu.data.dataset import collate_batch
from idiaptts_tpu.models import intonation as jax_int
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.train import atom_trainers as jax_tr
from idiaptts_torch.data import atoms as torch_atoms
from idiaptts_torch.data import wcad as torch_wcad
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.models import convert, flax_init
from idiaptts_torch.models import intonation as torch_int
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.train import atom_trainers as torch_tr

THETAS = (0.03, 0.06, 0.09, 0.12, 0.15)
WCAD = "wcad-0.030_0.060_0.090_0.120_0.150"
LR = 1e-3
REL = 1e-3      # the filter gains: XLA's exp against PyTorch's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- atoms and wcad -----------------------------------------------------------

@pytest.mark.parametrize("vuv_dist", [False, True])
def test_atom_readers_match_jax(fixtures_dir, id_list, vuv_dist):
    """AtomLabelGen and AtomVUVDistPosLabelGen: the same samples, peaks,
    labels and LF0 reconstruction as the JAX readers (exact)."""
    kwargs = dict(name="atoms", directory=os.path.join(fixtures_dir, WCAD),
                  thetas=THETAS)
    mods = (jax_atoms, torch_atoms)
    if vuv_dist:
        kwargs["dir_world"] = os.path.join(fixtures_dir, "WORLD")
        readers = [m.AtomVUVDistPosLabelGen.Config(**kwargs).create_reader()
                   for m in mods]
    else:
        readers = [m.AtomLabelGen.Config(**kwargs).create_reader()
                   for m in mods]
    for id_name in id_list:
        ref, got = (r[id_name]["atoms"] for r in readers)
        np.testing.assert_array_equal(got, ref)
        amps = got[:, :len(THETAS)]
        ref_lab, got_lab = (r.postprocess_sample(amps, identify_peaks=True)
                            for r in readers)
        np.testing.assert_array_equal(got_lab, ref_lab)
        np.testing.assert_array_equal(
            torch_atoms.AtomLabelGen.labels_to_lf0(got_lab, amp_threshold=0.1),
            jax_atoms.AtomLabelGen.labels_to_lf0(ref_lab, amp_threshold=0.1))
        np.testing.assert_array_equal(readers[1].load_phrase(id_name),
                                      readers[0].load_phrase(id_name))


def test_wcad_gen_data_matches_jax(fixtures_dir, id_list, tmp_path):
    """The matching pursuit and gen_data write the JAX package's files
    byte for byte, with the same statistics."""
    ids = list(id_list)[:3]
    world = os.path.join(fixtures_dir, "WORLD")
    stats = []
    for name, mod in (("jax", jax_wcad), ("port", torch_wcad)):
        stats.append(mod.gen_data(world, THETAS, str(tmp_path / name), ids,
                                  max_atoms=20))
    for a, b in zip(*stats):
        np.testing.assert_array_equal(a, b)
    for id_name in ids:
        for ext in (".atoms", ".phrase"):
            with open(tmp_path / "jax" / (id_name + ext), "rb") as f:
                ref = f.read()
            with open(tmp_path / "port" / (id_name + ext), "rb") as f:
                assert f.read() == ref, id_name + ext
    sample = WorldFeatLabelGen.load_sample(ids[0], world, load_sp=False,
                                           load_bap=False)
    ref = jax_wcad.decompose(sample[:, 0], sample[:, 1], THETAS)
    got = torch_wcad.decompose(sample[:, 0], sample[:, 1], THETAS)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


# -- filter banks -------------------------------------------------------------

@pytest.mark.parametrize("bank", ["critical", "complex"])
def test_filter_bank_forward_backward(bank):
    """Both banks' outputs, and the gradients with respect to the input
    and the parameters, against jax.grad of the flax bank."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 60, 5).astype(np.float32) * (rng.rand(2, 60, 5) > 0.9)
    moduli = tuple(jax_int.theta_to_modulus(np.asarray(THETAS)))
    w = rng.randn(2, 60, 1).astype(np.float32)
    if bank == "critical":
        jb, tb = jax_int.CriticalFilterBank(moduli), \
            torch_int.CriticalFilterBank(moduli)
    else:
        jb, tb = jax_int.ComplexFilterBank(moduli, 0.1), \
            torch_int.ComplexFilterBank(moduli, 0.1)
    variables = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if bank == "complex":
        variables = {"params": {"pole_logit": variables["params"][
            "pole_logit"], "phase": jnp.asarray(rng.randn(5) * 0.3,
                                                jnp.float32)}}
    convert.load_flax_params(tb, _to_np(variables))

    def loss(params, xin):
        return jnp.sum(jb.apply(params, xin) * w)

    ref_out = np.asarray(jax.jit(jb.apply)(variables, jnp.asarray(x)))
    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tb(xt)
    (out * torch.from_numpy(w)).sum().backward()
    scale = np.abs(ref_out).max()
    assert np.abs(out.detach().numpy() - ref_out).max() <= REL * scale
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x),
                               atol=REL * np.abs(np.asarray(g_x)).max())
    for name, p in tb.named_parameters():
        ref = np.asarray(g_params["params"][name])
        np.testing.assert_allclose(p.grad.numpy(), ref,
                                   atol=REL * np.abs(ref).max(), rtol=REL)


def _atom_model(mod, num_questions, out_dim=7):
    """A small atom model: 5 amplitudes, or with the position and vuv
    columns 7."""
    cfg = mod.convert_legacy_string(
        "RNNDYN-1_RELU_16-1_FC_{}".format(out_dim), num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_atoms",)
    return cfg


@pytest.mark.parametrize("phrase", [False, True])
def test_neural_filters_match_jax(num_questions, phrase):
    """NeuralFilters / PhraseNeuralFilters on the JAX draw: outputs
    and the parameter tree (flax_init repeats the JAX draw)."""
    configs = []
    for mod, rnn in ((jax_int, jax_rnn), (torch_int, torch_rnn)):
        cfg = mod.NeuralFilters.Config(
            atom_model_config=_atom_model(rnn, num_questions), thetas=THETAS,
            input_names=("questions",), output_names=("pred_intonation",))
        if phrase:
            cfg = mod.PhraseNeuralFilters.Config(
                neural_filters_config=cfg, phrase_bias_init=5.2,
                input_names=("questions",), output_names=("x",))
        configs.append(cfg)
    rng = np.random.RandomState(1)
    q = rng.rand(2, 40, num_questions).astype(np.float32)
    lengths = np.array([40, 31])
    jm = configs[0].create_model()
    variables = jm.init(jax.random.PRNGKey(1234), {"questions": q},
                        lengths=jnp.asarray(lengths), training=False)
    drawn = convert.flatten_flax(flax_init.model_params(configs[1]))
    ref_tree = convert.flatten_flax(_to_np(variables))
    assert set(drawn) == set(ref_tree)
    for key, value in ref_tree.items():
        np.testing.assert_allclose(drawn[key], value, atol=2e-6)
    model = configs[1].create_model()
    convert.load_flax_params(model, _to_np(variables))
    ref = jax.jit(lambda v, d, n: jm.apply(v, d, lengths=n))(
        variables, {"questions": q}, jnp.asarray(lengths))
    got = model({"questions": torch.from_numpy(q)},
                lengths=torch.from_numpy(lengths))
    key = "pred_intonation_phrase" if phrase else "pred_intonation"
    ref_out = np.asarray(ref[key])
    assert np.abs(got[key].detach().numpy() - ref_out).max() <= \
        REL * np.abs(ref_out).max()


# -- trainers -----------------------------------------------------------------

def _dirs(fixtures_dir):
    return dict(dir_question_labels=os.path.join(fixtures_dir, "questions"),
                dir_atom_labels=os.path.join(fixtures_dir, WCAD),
                dir_world_features=os.path.join(fixtures_dir, "WORLD"))


def _hp(cls, num_questions, port):
    hp = cls.create_hparams()
    hp.num_questions = num_questions
    hp.thetas = list(THETAS)
    hp.learning_rate = LR
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.0
    hp.batch_size_train = 3
    if port:
        hp.device = "cpu"
    return hp


def _trainer_pair(name, fixtures_dir, id_list, num_questions):
    """(jax trainer, port trainer), the port's weights the JAX draw's,
    for each of the four trainers; the composed ones adopt an atom
    model (and a flat model) as the phrase recipe does."""
    made = []
    for mod, rnn, port in ((jax_tr, jax_rnn, False),
                           (torch_tr, torch_rnn, True)):
        dirs = _dirs(fixtures_dir)
        cls = getattr(mod, name)
        atom_cls = mod.AtomModelTrainer if name == "AtomModelTrainer" \
            else mod.AtomVUVDistPosModelTrainer
        atom = atom_cls(_hp(atom_cls, num_questions, port), list(id_list),
                        **dirs)
        atom.init(atom.hparams, model_config=_atom_model(
            rnn, num_questions, 5 if name == "AtomModelTrainer" else 7))
        trainer = atom
        if name in ("AtomNeuralFilterModelTrainer",
                    "PhraseAtomNeuralFilterModelTrainer"):
            flat_cls = mod.AtomNeuralFilterModelTrainer
            flat = flat_cls(_hp(flat_cls, num_questions, port),
                            list(id_list), **dirs)
            flat.init_atom(flat.hparams, atom)
            flat.init(flat.hparams)
            flat.adopt_atom_params()
            trainer = flat
        if name == "PhraseAtomNeuralFilterModelTrainer":
            phrase = cls(_hp(cls, num_questions, port), list(id_list),
                         **dirs)
            phrase.init_flat(phrase.hparams, flat)
            phrase.init(phrase.hparams)
            phrase.adopt_flat_params()
            trainer = phrase
        made.append((atom, trainer))
    (j_atom, jt), (t_atom, tt) = made
    convert.load_flax_params(t_atom.model_handler.model,
                             _to_np(j_atom.model_handler.params))
    if tt is not t_atom:
        convert.load_flax_params(tt.model_handler.model,
                                 _to_np(jt.model_handler.params))
    return jt, tt


@pytest.mark.parametrize("name", [
    "AtomModelTrainer", "AtomVUVDistPosModelTrainer",
    "AtomNeuralFilterModelTrainer", "PhraseAtomNeuralFilterModelTrainer"])
def test_atom_trainer_step_matches_jax(fixtures_dir, id_list, num_questions,
                                       name):
    """One Adam step of each trainer's handler on the same batch of
    three fixture utterances, from the same weights."""
    jt, tt = _trainer_pair(name, fixtures_dir, id_list, num_questions)
    ids = ["gen-0001", "gen-0003", "gen-0004"]
    batch = collate_batch([tt.dataset_train.get_id_name(i)[0] for i in ids])
    ref_batch = collate_batch([jt.dataset_train.get_id_name(i)[0]
                               for i in ids])
    for key in ref_batch:
        if not key.startswith("_"):
            np.testing.assert_allclose(batch[key], ref_batch[key],
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    loss_j, _ = jt.model_handler.process_batches([ref_batch])
    loss_t, _ = tt.model_handler.process_batches([batch])
    assert loss_t == pytest.approx(loss_j, rel=1e-4)
    ref = convert.flax_to_state_dict(_to_np(jt.model_handler.params))
    got = tt.model_handler.model.state_dict()
    assert set(ref) == set(got)
    for key, value in ref.items():
        assert (got[key] - value).abs().max().item() <= 2 * LR + 1e-6, key


def test_adoption_shares_no_storage(fixtures_dir, id_list, num_questions):
    """The composed trainers hold copies of the adopted weights: a step
    of the phrase trainer moves neither the flat nor the atom model."""
    _, phrase = _trainer_pair("PhraseAtomNeuralFilterModelTrainer",
                              fixtures_dir, id_list, num_questions)
    flat = phrase.flat_trainer
    atom = flat.atom_trainer
    models = [atom.model_handler.model, flat.model_handler.model,
              phrase.model_handler.model]
    ptrs = [{p.data_ptr() for p in m.parameters()} for m in models]
    assert not ptrs[0] & ptrs[1] and not ptrs[1] & ptrs[2] \
        and not ptrs[0] & ptrs[2]
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in models[:2]]
    np.testing.assert_array_equal(
        models[2].neural_filters.atom_model.wrapped.g0_Linear_0.kernel
        .detach().numpy(),
        before[0]["wrapped.g0_Linear_0.kernel"].numpy())
    batch = collate_batch([phrase.dataset_train.get_id_name(i)[0]
                           for i in ("gen-0001", "gen-0002")])
    phrase.model_handler.process_batches([batch])
    for model, state in zip(models[:2], before):
        for key, value in model.state_dict().items():
            assert torch.equal(value, state[key]), key
