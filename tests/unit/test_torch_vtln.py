"""VTLN and the named-module compositions of the port against the JAX
package: the warp matrices, ``all_pass_warp`` and the composition law,
``grad_scale``'s gradient, ``Sequential``, ``NamedForwardSplitter`` and
``NamedForwardCombiner``, the warp layer inside a ``Sequential`` on the
JAX draw, one VTLN trainer step and the MCD sweep of ``compute_score``.

Tolerances, measured: the polynomial tensor exactly.  The warp matrix
sums 2n powers of alpha times coefficients up to 1e11 (n = 20) that
cancel; XLA rounds the powers (its blocked ``cumprod``) and the sums
otherwise than PyTorch, so entries (at most 1) agree within 1e-4
(measured 3.3e-5) and warped features within 5e-5 of their magnitude
(measured 1.1e-5); at n = 4 within 1e-6.  At n = 60 both packages'
matrices hold NaN at the same entries (float32 overflow).  The VTLN
model's outputs within 1e-4 of their magnitude, its gradients within
1e-2 (the pre-net's Dense layers give bf16 gradients: one bf16 ulp,
measured 5e-3); the trainer step as test_torch_intonation.py's (loss within
1e-4, parameters within 2 lr).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.data.category import CategoryDataReader as JaxCategory
from idiaptts_tpu.data.dataset import collate_batch
from idiaptts_tpu.models import named as jax_named
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.models import vtln as jax_vtln
from idiaptts_tpu.train import vtln_trainer as jax_tr
from idiaptts_torch.data.category import CategoryDataReader
from idiaptts_torch.models import convert, flax_init
from idiaptts_torch.models import named as torch_named
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.models import vtln as torch_vtln
from idiaptts_torch.train import vtln_trainer as torch_tr

LR = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("n", [4, 20, 60])
def test_warp_matrices_match_jax(n):
    np.testing.assert_array_equal(torch_vtln.gen_w_matrix_3d(n),
                                  jax_vtln.gen_w_matrix_3d(n))
    alphas = np.random.RandomState(n).uniform(-0.2, 0.2, (30, 50, 1)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jax_vtln.get_warp_matrix, static_argnums=1)(
        jnp.asarray(alphas), n))
    got = torch_vtln.get_warp_matrix(torch.from_numpy(alphas), n).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if n == 60:     # the finite entries are overflow residue
        return
    assert np.abs(got - ref).max() <= (1e-6 if n == 4 else 1e-4)
    # alpha = 0 is the identity warp.
    eye = torch_vtln.get_warp_matrix(torch.zeros(1, 1), n)[0].numpy()
    np.testing.assert_array_equal(eye, np.eye(n, dtype=np.float32))


@pytest.mark.parametrize("dim", [20, 67])
def test_all_pass_warp_and_composition_match_jax(dim):
    rng = np.random.RandomState(dim)
    feats = rng.randn(30, 50, dim).astype(np.float32)
    parts = [rng.uniform(-0.1, 0.1, (30, 50, 1)).astype(np.float32)
             for _ in range(2)]
    ref_a = jax_vtln.combine_warping_parameters(
        [jnp.asarray(p) for p in parts])
    got_a = torch_vtln.combine_warping_parameters(
        [torch.from_numpy(p) for p in parts])
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), rtol=1e-6)
    ref = np.asarray(jax.jit(jax_vtln.all_pass_warp, static_argnums=2)(
        jnp.asarray(feats), ref_a, 20))
    got = torch_vtln.all_pass_warp(torch.from_numpy(feats), got_a, 20)
    assert np.abs(got.numpy() - ref).max() <= 5e-5 * np.abs(ref).max()


def test_grad_scale_gradient():
    """Identity forward; the gradient times lambda backward, as the JAX
    custom_vjp gives it."""
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    w = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(jax_vtln.grad_scale(v, 200.0) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = torch_vtln.grad_scale(xt, 200.0)
    assert torch.equal(out, xt.detach())
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))


def test_splitter_combiner_sequential_match_jax():
    """Splitter -> Combiner -> Sequential of both, on a dict."""
    rng = np.random.RandomState(2)
    data = {"a": rng.randn(2, 5, 7).astype(np.float32),
            "b": rng.randn(2, 3).astype(np.float32)}
    outs = []
    for mod in (jax_named, torch_named):
        split = mod.NamedForwardSplitter.Config(
            split_sizes=(3, 4), input_names=("a",), output_names=("x", "y"))
        comb = mod.NamedForwardCombiner.Config(
            input_names=("y", "b", "x"), output_names=("z",))
        seq = mod.Sequential.Config(module_configs=[split, comb],
                                    input_names=("a", "b"),
                                    output_names=("z",))
        model = seq.create_model()
        if mod is jax_named:
            variables = model.init(jax.random.PRNGKey(0), data)
            assert not variables
            outs.append({k: np.asarray(v) for k, v in model.apply(
                variables, data).items()})
        else:
            outs.append({k: v.numpy() if torch.is_tensor(v) else v
                         for k, v in model({k: torch.from_numpy(v) for k, v
                                            in data.items()}).items()})
    assert set(outs[0]) == set(outs[1]) == {"a", "b", "x", "y", "z"}
    for key in outs[0]:
        np.testing.assert_array_equal(outs[1][key], outs[0][key])


def _vtln_config(mod, rnn, num_questions, hparams):
    pre_net = rnn.convert_legacy_string("RNNDYN-1_RELU_32-1_FC_67",
                                        num_questions)
    pre_net.input_names = ("questions",)
    pre_net.output_names = ("pre_net_output",)
    trainer_cls = mod.VTLNSpeakerAdaptionModelTrainer
    return trainer_cls.build_model_config(None, hparams, pre_net, 20)


def test_warp_layer_in_sequential_matches_jax(num_questions):
    """The VTLN model (pre-net, then the warp layer, in a Sequential) on
    the JAX draw: the flax_init tree, the warped output and alphas, and
    the gradients of a loss through grad_scale."""
    hp = torch_tr.VTLNSpeakerAdaptionModelTrainer.create_hparams()
    hp.warp_matrix_size = 20
    cfg_j = _vtln_config(jax_tr, jax_rnn, num_questions, hp)
    cfg_t = _vtln_config(torch_tr, torch_rnn, num_questions, hp)
    cfg_t.module_configs[1].alpha_layer_in_dims = (1,)
    rng = np.random.RandomState(3)
    data = {"questions": rng.rand(2, 12, num_questions).astype(np.float32),
            "speaker_embedding": rng.rand(2, 1).astype(np.float32)}
    lengths = np.array([12, 9])
    jm = cfg_j.create_model()
    variables = jm.init(jax.random.PRNGKey(1234), data,
                        lengths=jnp.asarray(lengths), training=True)
    ref_tree = convert.flatten_flax(_to_np(variables))
    drawn = convert.flatten_flax(flax_init.model_params(cfg_t))
    assert set(drawn) == set(ref_tree)
    for key, value in ref_tree.items():
        np.testing.assert_allclose(drawn[key], value, atol=2e-6)
    model = cfg_t.create_model()
    convert.load_flax_params(model, _to_np(variables))
    w = rng.randn(2, 12, 67).astype(np.float32)

    def loss(v):
        out = jm.apply(v, data, lengths=jnp.asarray(lengths))
        return jnp.sum(out["pred_acoustic_features"] * w), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables)
    got = model({k: torch.from_numpy(v) for k, v in data.items()},
                lengths=torch.from_numpy(lengths))
    for key in ("pred_acoustic_features", "alphas"):
        r = np.asarray(ref[key])
        assert np.abs(got[key].detach().numpy() - r).max() <= \
            1e-4 * np.abs(r).max(), key
    (got["pred_acoustic_features"] * torch.from_numpy(w)).sum().backward()
    ref_g = convert.flax_to_state_dict(_to_np(grads))
    for name, p in model.named_parameters():
        r = ref_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r,
                                   atol=1e-2 * np.abs(r).max(), err_msg=name)


def _trainer(mod, rnn, category, fixtures_dir, id_list, num_questions,
             tmp_path, port):
    cls = mod.VTLNSpeakerAdaptionModelTrainer
    hp = cls.create_hparams()
    hp.num_questions = num_questions
    hp.num_coded_sps = 20
    hp.out_dir = str(tmp_path)
    hp.model_name = "vtln"
    hp.learning_rate = LR
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.batch_size_train = 3
    hp.batch_size_benchmark = 6
    hp.warp_matrix_size = 20
    if port:
        hp.device = "cpu"
    trainer = cls(hp, list(id_list),
                  dir_question_labels=os.path.join(fixtures_dir, "questions"),
                  dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    readers = trainer.default_data_reader_configs(hp)
    readers.append(category.Config(name="speaker_embedding",
                                   get_category_fn=lambda idn: [0.5]))
    trainer.init(hp, model_config=_vtln_config(mod, rnn, num_questions, hp),
                 data_reader_configs=readers)
    return trainer


def test_vtln_trainer_step_and_mcd_sweep(fixtures_dir, id_list,
                                         num_questions, tmp_path):
    """One Adam step of the VTLN trainer against the JAX trainer's, from
    the JAX draw; then ``benchmark`` (MLPG post-processing) on both
    trainers' weights after the step: the scores and the MCD sweep."""
    jt = _trainer(jax_tr, jax_rnn, JaxCategory, fixtures_dir, id_list,
                  num_questions, tmp_path / "jax", False)
    tt = _trainer(torch_tr, torch_rnn, CategoryDataReader, fixtures_dir,
                  id_list, num_questions, tmp_path / "port", True)
    assert tt.model_handler.model_config.module_configs[1] \
        .alpha_layer_in_dims == (1,)
    convert.load_flax_params(tt.model_handler.model,
                             _to_np(jt.model_handler.params))
    ids = tt.id_list_train[:3]
    batch = collate_batch([tt.dataset_train.get_id_name(i)[0] for i in ids])
    loss_j, _ = jt.model_handler.process_batches([batch])
    loss_t, _ = tt.model_handler.process_batches([batch])
    assert loss_t == pytest.approx(loss_j, rel=1e-4)
    ref = convert.flax_to_state_dict(_to_np(jt.model_handler.params))
    got = tt.model_handler.model.state_dict()
    for key, value in ref.items():
        assert (got[key] - value).abs().max().item() <= 2 * LR + 1e-6, key
    # Score the same weights: the JAX trainer's after its step.
    convert.load_flax_params(tt.model_handler.model,
                             _to_np(jt.model_handler.params))
    ref_scores = jt.benchmark(jt.hparams, jt.id_list_train)
    got_scores = tt.benchmark(tt.hparams, tt.id_list_train)
    np.testing.assert_allclose(got_scores, ref_scores, rtol=1e-3)
    assert set(tt.mcd_sweep) == {"MCD_5", "MCD_10", "MCD_20"}
    assert tt.mcd_sweep["MCD_20"] == pytest.approx(got_scores[0], rel=1e-6)
    assert all(np.isfinite(v) and v > 0 for v in tt.mcd_sweep.values())
