"""Tensor-parallel training of the port (``idiaptts_torch/parallel/mesh.py``,
the sharded ``_Dense`` / ``_BiFastLSTM`` and the handler's
``setup_mesh(model_parallel=M)``) against the port's one-process step and
the JAX handler's ``setup_mesh(num_devices, model_parallel=2)`` step.

Gloo ranks run as subprocesses on the CPU (``RANK``/``WORLD_SIZE`` as
torchrun sets them, a free localhost port), each importing only the
port: a world of 2 ranks (model 2) and one of 4 ranks, which trains over
(data 2 x model 2) and then (data 1 x model 4).  The JAX side runs in
this process on conftest's virtual CPU devices, from the same initial
weights (``convert.py``) and the variable-length 8-row batch of
``tests/unit/test_shard_map_training.py`` (SGD, lr 0.01, masked MSE).

Tolerances:
- A float32 model (Conv1d, BatchNorm, Conv1d; every layer replicated in
  the port, its Conv kernels sharded in the JAX step) isolates the
  harness: against the JAX step the JAX test's own bounds, losses rtol
  1e-5, parameters and running averages rtol 1e-3 atol 1e-5; against the
  one process losses rtol 1e-6, parameters rtol 1e-5 atol 1e-7
  (measured 9.2e-8 and 3.0e-8).  BatchNorm's batch statistics cover the
  data group's rows, as the JAX GSPMD step's do (not each rank's, as the
  data-parallel ``shard_map`` step's).
- The JAX test's model ``RNNDYN-1_RELU_32-1_BiLSTM_128-1_FC_4`` has both
  sharded layers (its Dense 32 and FC 4 column-parallel, its BiLSTM
  split by direction).  Against the port's one process: losses rtol
  1e-4, the grad norm rtol 1e-3, parameters rtol 1e-3 atol 1e-5, the
  data-parallel test's bounds (measured 3.5e-6, 1.3e-4 and 4.9e-6
  absolute): a column-parallel layer's input gradient is the
  float32 sum of the ranks' bf16 products, where one process rounds one
  bf16 product, and the batch splits over data ranks as in data
  parallelism.  Against the JAX step at bf16 scale (ROADMAP fault 3.2:
  XLA accumulates bf16 matmuls in bf16 on the CPU): losses rtol 2e-4,
  parameters rtol 1e-3 atol 1e-4, as the data-parallel test.
- A batch that does not divide over ``data`` runs whole in each model
  group; one of fewer rows than the BiLSTM's row blocks runs whole on
  every rank of the model group.
- The one-direction plain versions against the two-direction ones: equal
  bit for bit where a direction's block of Bp x F floats is a multiple
  of 32, as are all the model's; PyTorch's vectorised CPU loops take 32
  floats an iteration and the activations of a shorter tail round
  differently, so elsewhere the recurrence agrees within 4 float32 ulps
  of h.  The card's one-direction kernels are held to the
  two-direction launch bit for bit at every shape
  (``test_torch_cuda_kernels.py``).
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from idiaptts_tpu.data.dataset import collate_batch
from idiaptts_tpu.hparams import ExtendedHParams as JaxHParams
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.models.losses import NamedLoss as JaxLoss
from idiaptts_tpu.parallel import mesh as jax_mesh
from idiaptts_tpu.train.handler import ModularModelHandler as JaxHandler
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models import convert
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.ops import cuda_lstm
from idiaptts_torch.parallel import mesh as torch_mesh
from idiaptts_torch.train.acoustic import AcousticModelTrainer
from idiaptts_torch.train.handler import ModularModelHandler

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LSTM_MODEL = "RNNDYN-1_RELU_32-1_BiLSTM_128-1_FC_4"
TRAINER_MODEL = "RNNDYN-1_RELU_32-1_BiLSTM_16-1_FC_67"
FLAGSHIP = "RNNDYN-2_RELU_64-2_BiLSTM_64-1_FC_67"
INTERSPEECH18 = "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67"
D = 12
LR = 0.01
CLIP = 0.05
# (world, model_parallel): the meshes each world trains over.
WORLDS = {2: (2,), 4: (2, 4)}
SCENARIOS = (("f32", "batch", 2), ("lstm", "batch", 2),
             ("lstm_clip", "batch", 1), ("lstm", "batch5", 1),
             ("lstm", "batch1", 1))

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs four virtual CPU devices")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(B=8, lengths=(17, 23, 9, 30, 21, 13, 27, 11), seed=0):
    rng = np.random.RandomState(seed)
    return collate_batch([{
        "x": rng.randn(lengths[i % len(lengths)], D).astype(np.float32),
        "target": rng.randn(lengths[i % len(lengths)], 4).astype(np.float32),
    } for i in range(B)])


def model_config(mod, kind):
    if kind.startswith("lstm"):
        cfg = mod.convert_legacy_string(LSTM_MODEL, D)
    else:
        cfg = mod.RNNDyn.Config(in_dim=D, layer_configs=[
            mod.LayerConfig("Conv1dTANH", out_dim=16, kernel_size=3),
            mod.LayerConfig("BatchNorm1d", out_dim=16),
            mod.LayerConfig("Conv1d", out_dim=4, kernel_size=1)])
    cfg.input_names = ("x",)
    cfg.output_names = ("pred",)
    return cfg


def port_handler(kind, state, optimiser="SGD"):
    handler = ModularModelHandler(device="cpu")
    handler.create_model(model_config(torch_rnn, kind))
    handler.model.load_state_dict(state)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = LR
    hp.optimiser_type = optimiser
    if kind.endswith("clip"):
        hp.grad_clip_norm_type = 2
        hp.grad_clip_max_norm = CLIP
    handler.set_optimiser(hp)
    handler.set_scheduler(hp)
    handler.set_losses([NamedLoss.Config("mse", "MSELoss", ("pred", "target"),
                                         seq_mask="_seq_mask")])
    return handler


def trainer_hparams(out_dir, num_questions, num_devices=1,
                    model_parallel=1):
    hp = AcousticModelTrainer.create_hparams()
    hp.num_questions = num_questions
    hp.num_coded_sps = 20
    hp.learning_rate = 1e-3
    hp.seed = 1
    hp.device = "cpu"
    hp.out_dir = out_dir
    hp.model_name = "acoustic"
    hp.epochs = 1
    hp.batch_size_train = 2
    hp.batch_size_val = 6
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.num_devices = num_devices
    hp.model_parallel = model_parallel
    return hp


def acoustic_trainer(fixtures_dir, id_list, hp, num_questions):
    trainer = AcousticModelTrainer(
        hp, list(id_list),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    cfg = torch_rnn.convert_legacy_string(TRAINER_MODEL, num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    trainer.init(hp, model_config=cfg)
    return trainer


def _state(params, batch_stats=None):
    tree = {"params": jax.tree_util.tree_map(np.asarray, params)}
    if batch_stats is not None:
        tree["batch_stats"] = jax.tree_util.tree_map(np.asarray,
                                                     batch_stats)
    return convert.flax_to_state_dict(tree)


def jax_handler(kind, batch):
    """The JAX handler of ``kind`` (SGD, masked MSE) and its initial
    weights as a port state dict."""
    handler = JaxHandler()
    handler.create_model(model_config(jax_rnn, kind), example_batch=batch)
    hp = JaxHParams.create_hparams()
    hp.learning_rate = LR
    hp.optimiser_type = "SGD"
    handler.set_optimiser(hp)
    handler.set_scheduler(hp)
    handler.set_losses([JaxLoss.Config("mse", "MSELoss", ("pred", "target"),
                                       seq_mask="_seq_mask")])
    return handler, _state(handler.params, handler.batch_stats)


def jax_tensor_parallel(kind, batch, num_devices, steps=2):
    """(losses, final state dict) of the JAX handler's (data, model) step
    with model_parallel=2."""
    handler, _ = jax_handler(kind, batch)
    handler.setup_mesh(num_devices, model_parallel=2)
    assert handler.mesh.devices.shape == (num_devices // 2, 2)
    losses = [handler.process_batches([batch])[0] for _ in range(steps)]
    return losses, _state(handler.params, handler.batch_stats)


# Each rank: the handler scenarios over each of its world's meshes, the
# checkpoints, the generic step and (world 2) the trainer.  Imports only
# the port.
WORKER = r"""
import os, sys
import torch
sys.path.insert(0, os.environ["TP_TEST_DIR"])
import tp_helpers as h
from idiaptts_torch.parallel import mesh

torch.set_num_threads(1)
d = os.environ["TP_WORK"]
blob = torch.load(os.path.join(d, "in.pt"), weights_only=False)
m = mesh.initialise_multihost(device="cpu")   # torchrun's environment
out = {"world": m.size}

def rows_log(handler):
    seen = []
    rule = handler.residuals_bf16_for
    handler.residuals_bf16_for = lambda r: (seen.append(r), rule(r))[1]
    return seen

def full(handler):
    return {k: v.detach().clone()
            for k, v in handler.full_state_dict().items()}

for M in blob["meshes"][m.size]:
    for kind, batch_key, steps in blob["scenarios"]:
        base = kind.split("_")[0]
        handler = h.port_handler(kind, blob["init_" + base])
        handler.setup_mesh(m.size, model_parallel=M)
        val = handler.process_batches([blob[batch_key]], training=False)[0]
        seen = rows_log(handler)
        losses, norms, states = [], [], []
        for _ in range(steps):
            losses.append(handler.process_batches([blob[batch_key]])[0])
            norms.append(handler.last_grad_norm)
            states.append(full(handler))
        out[(M, kind, batch_key)] = {
            "losses": losses, "norms": norms, "states": states,
            "rows": seen, "val": val, "mesh": repr(handler.mesh),
            "bytes": sum(p.numel() * p.element_size()
                         for p in handler.model.parameters())}

    # Checkpoints both ways, with Adam's moments.
    handler = h.port_handler("lstm", blob["init_lstm"], "Adam")
    handler.setup_mesh(m.size, model_parallel=M)
    handler.process_batches([blob["batch"]])
    ckpt = os.path.join(d, "tp_ckpt_{}_{}".format(m.size, M))
    handler.save_checkpoint(ckpt, "tp", step=1)
    loaded = h.port_handler("lstm", blob["init_lstm"], "Adam")
    loaded.setup_mesh(m.size, model_parallel=M)
    loaded.load_checkpoint(blob["one_ckpt"], "one", step=1)
    opt = loaded._optimiser_state(loaded.optimiser.state_dict(), gather=True)
    out[(M, "ckpt")] = {"saved": full(handler), "loaded": full(loaded),
                        "loaded_opt": {i: {k: v.clone() for k, v in e.items()}
                                       for i, e in opt["state"].items()},
                        "loss_after": loaded.process_batches(
                            [blob["batch"]])[0]}

# The generic step on a Dense model sharded over the whole world.
torch.manual_seed(0)
cfg = h.torch_rnn.convert_legacy_string("RNNDYN-1_RELU_8-1_FC_4", 3)
model = cfg.create_model()
tp = mesh.make_2d_mesh(m.size, model_parallel=2, device="cpu")
mesh.shard_module(model, tp)
opt = torch.optim.SGD(model.parameters(), lr=0.1)
step = mesh.make_tp_train_step(
    lambda b: ((model(b["x"]) - b["y"]) ** 2).mean(), opt, tp)
out["generic"] = {"loss": float(step(blob["generic"])),
                  "state": mesh.gather_state_dict(model, tp)}

if m.size == 2:
    hp = h.trainer_hparams(blob["out_dir"], blob["num_questions"], 2, 2)
    trainer = h.acoustic_trainer(blob["fixtures"], blob["ids"], hp,
                                 blob["num_questions"])
    val_loss, train_loss = trainer.train(trainer.hparams)
    trainer.save_checkpoint(trainer.hparams, epoch=9)
    out["trainer"] = {"val": val_loss, "train": train_loss,
                      "writer": trainer.is_writer,
                      "state": full(trainer.model_handler),
                      "benchmark": trainer.forward(
                          trainer.hparams, blob["ids"][:2])}
torch.save(out, os.path.join(d, "out{}_{}.pt".format(m.size, m.rank)))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _source(fn):
    import inspect
    return inspect.getsource(fn)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, fixtures_dir, id_list, num_questions):
    work = tmp_path_factory.mktemp("tp")
    batch = make_batch()
    blob = {"batch": batch,
            "batch5": make_batch(B=5, lengths=(17, 23, 9, 30, 21)),
            "batch1": make_batch(B=1, lengths=(19,)),
            "generic": {"x": torch.randn(6, 5, 3, generator=torch.Generator()
                                         .manual_seed(1)),
                        "y": torch.randn(6, 5, 4, generator=torch.Generator()
                                         .manual_seed(2))},
            "fixtures": fixtures_dir, "ids": list(id_list),
            "num_questions": num_questions,
            "out_dir": str(work / "trainer"), "meshes": WORLDS,
            "scenarios": SCENARIOS, "one_ckpt": str(work / "one_ckpt")}
    for kind in ("f32", "lstm"):
        blob["init_" + kind] = jax_handler(kind, batch)[1]
    # A one-process checkpoint with Adam's moments for the ranks to load.
    one = port_handler("lstm", blob["init_lstm"], "Adam")
    one.process_batches([batch])
    one.save_checkpoint(blob["one_ckpt"], "one", step=1)
    torch.save(blob, work / "in.pt")
    helpers = work / "tp_helpers.py"
    helpers.write_text(
        "import os\nfrom idiaptts_torch.hparams import ExtendedHParams\n"
        "from idiaptts_torch.models import rnn_dyn as torch_rnn\n"
        "from idiaptts_torch.models.losses import NamedLoss\n"
        "from idiaptts_torch.train.acoustic import AcousticModelTrainer\n"
        "from idiaptts_torch.train.handler import ModularModelHandler\n"
        "LSTM_MODEL, TRAINER_MODEL, D, LR, CLIP = {!r}, {!r}, {}, {}, {}\n"
        .format(LSTM_MODEL, TRAINER_MODEL, D, LR, CLIP)
        + "\n".join(_source(f) for f in (model_config, port_handler,
                                         trainer_hparams,
                                         acoustic_trainer)))
    procs = []
    for world in WORLDS:
        env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
                   TP_WORK=str(work), TP_TEST_DIR=str(work),
                   MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        procs += [subprocess.Popen(
            [sys.executable, "-c", WORKER], cwd=str(work),
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    try:
        # The JAX steps run while the ranks do.
        jax_runs = {}
        for kind in ("f32", "lstm"):
            for n in WORLDS:
                losses, final = jax_tensor_parallel(kind, batch, n)
                jax_runs[(kind, n)] = {"losses": losses, "final": final}
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = {world: [torch.load(work / "out{}_{}.pt".format(world, r),
                                weights_only=False) for r in range(world)]
             for world in WORLDS}
    return {"blob": blob, "jax": jax_runs, "ranks": ranks, "work": work}


def _one_process(kind, blob, batch_key, steps):
    handler = port_handler(kind, blob["init_" + kind.split("_")[0]])
    losses, norms = [], []
    for _ in range(steps):
        losses.append(handler.process_batches([blob[batch_key]])[0])
        norms.append(handler.last_grad_norm)
    return handler, losses, norms


def _every_run(runs):
    """(world, M, rank index, rank output) of every rank of every mesh."""
    for world, meshes in WORLDS.items():
        for M in meshes:
            for r, rank in enumerate(runs["ranks"][world]):
                yield world, M, r, rank


def test_meshes_are_the_jax_grid(runs):
    """rank = data index * M + model index."""
    for world, M, r, rank in _every_run(runs):
        got = rank[(M, "lstm", "batch")]["mesh"]
        assert got.startswith("TensorMesh(data={}/{}, model={}/{}".format(
            r // M, world // M, r % M, M)), got


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_step_matches_jax_float32(runs, world):
    """The JAX test's bounds on a float32 model, BatchNorm included; the
    JAX step at (data world/2 x model 2)."""
    ref = runs["jax"][("f32", world)]
    for rank in runs["ranks"][world]:
        got = rank[(2, "f32", "batch")]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        final = got["states"][-1]
        assert sorted(final) == sorted(ref["final"])
        for name, value in ref["final"].items():
            np.testing.assert_allclose(final[name].numpy(), value.numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_step_matches_jax_bilstm(runs, world):
    """The JAX test's BiLSTM model at bf16 scale (module docstring)."""
    ref = runs["jax"][("lstm", world)]
    got = runs["ranks"][world][0][(2, "lstm", "batch")]
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4)
    for name, value in ref["final"].items():
        np.testing.assert_allclose(got["states"][-1][name].numpy(),
                                   value.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("kind,batch_key,steps", SCENARIOS)
def test_step_matches_one_process(runs, kind, batch_key, steps):
    """Every mesh (model 2; data 2 x model 2; data 1 x model 4) against
    the port's one process: losses, the evaluation loss, the grad norm,
    the gathered parameters and BatchNorm's running averages."""
    one, losses, norms = _one_process(kind, runs["blob"], batch_key, steps)
    ref = one.model.state_dict()
    fresh = port_handler(kind, runs["blob"]["init_" + kind.split("_")[0]])
    val = fresh.process_batches([runs["blob"][batch_key]],
                                training=False)[0]
    f32 = kind == "f32"
    for _, M, _, rank in _every_run(runs):
        got = rank[(M, kind, batch_key)]
        assert got["val"] == pytest.approx(val, rel=1e-6 if f32 else 1e-4)
        np.testing.assert_allclose(got["losses"], losses,
                                   rtol=1e-6 if f32 else 1e-4)
        np.testing.assert_allclose(got["norms"], norms, rtol=1e-3)
        for name, value in ref.items():
            torch.testing.assert_close(
                got["states"][-1][name], value,
                rtol=1e-5 if f32 else 1e-3, atol=1e-7 if f32 else 1e-5,
                msg=lambda m, n=name: "{} {}".format(n, m))


def test_clipping_uses_the_global_norm(runs):
    """With grad_clip_max_norm below the gradients' norm every rank
    scales its shards by the whole model's norm."""
    _, _, norms = _one_process("lstm_clip", runs["blob"], "batch", 1)
    assert norms[0] > CLIP
    for _, M, _, rank in _every_run(runs):
        assert rank[(M, "lstm_clip", "batch")]["norms"][0] == \
            pytest.approx(norms[0], rel=1e-3)


def test_ranks_of_a_model_group_stay_equal(runs):
    for world, meshes in WORLDS.items():
        for M in meshes:
            states = [r[(M, "lstm", "batch")]["states"][-1]
                      for r in runs["ranks"][world]]
            for state in states[1:]:
                for name in state:
                    assert torch.equal(state[name], states[0][name]), name


def test_each_rank_holds_its_share_of_the_weights(runs):
    """One BiLSTM direction a rank, and 1/M of each Dense kernel whose
    columns M divides into shards of two or more (the FC 4 at M = 4
    stays whole)."""
    model = model_config(torch_rnn, "lstm").create_model()
    want = {}
    for M in (2, 4):
        want[M] = 0
        for name, p in model.named_parameters():
            share = 1
            if ".bi0." in name:
                share = 2
            elif name.endswith("kernel") and p.shape[-1] // M >= 2:
                share = M
            want[M] += p.numel() * 4 // share
    for _, M, _, rank in _every_run(runs):
        assert rank[(M, "lstm", "batch")]["bytes"] == want[M]


def test_residual_rows_are_the_ranks_launch(runs):
    """The residual precision follows the rows of the rank's recurrence
    launch: all 8 at model 2, its block of 4 at model 4 (data 1), where
    data 2 x model 2 gives each rank 4 rows."""
    for world, meshes in WORLDS.items():
        for M in meshes:
            for rank in runs["ranks"][world]:
                rows = rank[(M, "lstm", "batch")]["rows"]
                want = {(2, 2): 8, (4, 2): 4, (4, 4): 4}[(world, M)]
                assert rows[0] == want, (world, M, rows)


def test_tp_checkpoint_loads_into_one_process(runs):
    """Rank 0 writes the gathered one-device state; a one-process handler
    loads it bit for bit, and so does the other way round, with Adam's
    moments."""
    blob = runs["blob"]
    one = port_handler("lstm", blob["init_lstm"], "Adam")
    one.load_checkpoint(blob["one_ckpt"], "one", step=1)
    one_opt = one.optimiser.state_dict()["state"]
    for world, M, _, rank in _every_run(runs):
        got = rank[(M, "ckpt")]
        fresh = port_handler("lstm", blob["init_lstm"], "Adam")
        fresh.load_checkpoint(
            str(runs["work"] / "tp_ckpt_{}_{}".format(world, M)), "tp",
            step=1)
        for name, value in got["saved"].items():
            assert torch.equal(fresh.model.state_dict()[name], value), name
        for name, value in one.model.state_dict().items():
            assert torch.equal(got["loaded"][name], value), name
        for idx, entry in one_opt.items():
            for k, v in entry.items():
                assert torch.equal(got["loaded_opt"][idx][k], v), (idx, k)
    after = one.process_batches([blob["batch"]])[0]
    for _, M, _, rank in _every_run(runs):
        assert rank[(M, "ckpt")]["loss_after"] == pytest.approx(
            after, rel=1e-4)


def test_generic_tp_train_step(runs):
    """make_tp_train_step on a mean-of-rows loss of a sharded Dense model:
    the one-process step on the whole batch."""
    blob = runs["blob"]["generic"]
    torch.manual_seed(0)
    model = torch_rnn.convert_legacy_string("RNNDYN-1_RELU_8-1_FC_4",
                                            3).create_model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    loss = ((model(blob["x"]) - blob["y"]) ** 2).mean()
    loss.backward()
    opt.step()
    for world in WORLDS:
        for rank in runs["ranks"][world]:
            got = rank["generic"]
            assert got["loss"] == pytest.approx(loss.item(), rel=1e-5)
            # One bf16 ulp of a gradient times the learning rate: the
            # FC layer's input gradient is summed over the ranks.
            for name, value in model.state_dict().items():
                torch.testing.assert_close(got["state"][name], value,
                                           rtol=1e-3, atol=2e-4)


def test_trainer_matches_one_process_and_rank0_writes(
        runs, fixtures_dir, id_list, num_questions, tmp_path):
    """AcousticModelTrainer with model_parallel=2 on two ranks against
    model_parallel=1 in one process (the JAX
    test_tensor_parallel_trainer_surface); rank 0 writes, and a
    one-process trainer loads the checkpoint it wrote."""
    hp = trainer_hparams(str(tmp_path), num_questions)
    trainer = acoustic_trainer(fixtures_dir, id_list, hp, num_questions)
    val_loss, train_loss = trainer.train(hp)
    r0, r1 = (r["trainer"] for r in runs["ranks"][2])
    assert r0["writer"] and not r1["writer"]
    for rank in (r0, r1):
        np.testing.assert_allclose(rank["train"], train_loss, rtol=1e-3)
        np.testing.assert_allclose(rank["val"], val_loss, rtol=1e-3)
    loaded = trainer_hparams(runs["blob"]["out_dir"], num_questions)
    loaded.load_from_checkpoint = True
    loaded.epoch_to_load = 9
    other = acoustic_trainer(fixtures_dir, id_list, loaded, num_questions)
    for name, value in r0["state"].items():
        assert torch.equal(other.model_handler.model.state_dict()[name],
                           value), name
    out = other.forward(loaded, list(id_list)[:2])
    for id_name, sample in out.items():
        np.testing.assert_allclose(
            sample["pred_acoustic_features"],
            r0["benchmark"][id_name]["pred_acoustic_features"],
            rtol=1e-3, atol=1e-3)


def test_sharding_rule_against_jax(runs):
    """make_param_shardings on the flagship and the Interspeech'18 models
    at M=2 and 4 against the JAX rule on the same parameters: the JAX
    rule everywhere but the stated departures (the BiLSTM by direction,
    Dense biases whole as JAX keeps them)."""
    for string in (FLAGSHIP, INTERSPEECH18):
        cfg = torch_rnn.convert_legacy_string(string, 409)
        params = dict(torch_rnn.RNNDyn(cfg).named_parameters())
        for M in (2, 4):
            mesh = torch_mesh.TensorMesh(
                torch_mesh.DataMesh(1, 0, "cpu"),
                torch_mesh.DataMesh(M, 0, "cpu"), "cpu")
            ours = torch_mesh.make_param_shardings(params, mesh)
            jmesh = jax_mesh.make_2d_mesh(M, model_parallel=M)
            theirs = jax_mesh.make_param_shardings(
                {k: np.zeros(v.shape, np.float32) for k, v in params.items()},
                jmesh)
            assert sorted(ours) == sorted(params)
            for name, dim in ours.items():
                spec = tuple(theirs[name].spec)
                jax_dim = spec.index("model") if "model" in spec else None
                if "_LSTM.bi" in name:
                    assert dim == 0 and jax_dim == params[name].dim() - 1, \
                        name
                else:
                    assert dim == jax_dim, (name, dim, jax_dim)


def test_odd_model_parallel_replicates_the_bilstm():
    """At M = 3 the BiLSTM has no direction split: replicated, and the
    layer runs both directions on every rank (its forward is the
    one-process forward)."""
    cfg = torch_rnn.convert_legacy_string("RNNDYN-1_RELU_32-1_BiLSTM_16-1_"
                                          "FC_4", D)
    model = cfg.create_model()
    mesh = torch_mesh.TensorMesh(torch_mesh.DataMesh(1, 0, "cpu"),
                                 torch_mesh.DataMesh(3, 1, "cpu"), "cpu")
    shardings = torch_mesh.make_param_shardings(model, mesh)
    assert all(v is None for k, v in shardings.items() if ".bi0." in k)
    x = torch.randn(2, 7, D, generator=torch.Generator().manual_seed(3))
    before = model(x)
    torch_mesh.shard_module(model, mesh, shardings)
    assert model.g1_LSTM.bi0.model_mesh is None
    assert model.g1_LSTM.bi0.Wx.shape[0] == 2
    assert torch.equal(model(x), before)


def test_shard_and_gather_round_trip():
    """A one-device state dict to each rank's pieces and back, exact, by
    concatenating the pieces as the gather's zero-padded sum places them
    (the collective itself runs in the ranks above)."""
    cfg = torch_rnn.convert_legacy_string(FLAGSHIP, 409)
    state = cfg.create_model().state_dict()
    for M in (2, 4):
        pieces = []
        for r in range(M):
            mesh = torch_mesh.TensorMesh(torch_mesh.DataMesh(1, 0, "cpu"),
                                         torch_mesh.DataMesh(M, r, "cpu"),
                                         "cpu")
            model = cfg.create_model()
            torch_mesh.shard_module(model, mesh)
            local = torch_mesh.shard_state_dict(state, model, mesh)
            model.load_state_dict(local)
            pieces.append((mesh, model, local))
        shards = torch_mesh.module_shards(pieces[0][1])
        assert shards
        for name, value in state.items():
            if name not in shards:
                for _, _, local in pieces:
                    assert torch.equal(local[name], value)
                continue
            shard = shards[name]
            first = [local[name] for mesh, _, local in pieces
                     if shard.holds_first(mesh)]
            assert torch.equal(torch.cat(first, dim=shard.dim), value), name


@pytest.mark.parametrize("T,B,D_,F", [(7, 4, 20, 16), (9, 2, 24, 32),
                                      (5, 3, 20, 16), (6, 1, 12, 16)])
def test_one_direction_plain_versions_are_the_halves(T, B, D_, F):
    """The plain projection, recurrence (inference and training) and
    backward on one direction's inputs against the two-direction plain
    versions' halves: equal where a direction's Bp x F is a multiple of
    32, within 4 float32 ulps of h elsewhere (module docstring); the
    autograd layer's gradients likewise."""
    g = torch.Generator().manual_seed(0)
    xin = torch.randn(T, 2 * B, D_, generator=g).bfloat16()
    wx = torch.randn(2, D_, 4 * F, generator=g) / D_ ** 0.5
    b = 0.1 * torch.randn(2, 4 * F, generator=g)
    wh = torch.randn(2 * F, 4 * F, generator=g) / F ** 0.5
    gout = torch.randn(T, 2 * B, F, generator=g)
    exact = B * F % 32 == 0

    def same(x, y):
        if exact:
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=4 * 2.0 ** -24)

    xp = cuda_lstm.projection_tmajor_plain(xin, wx, b)
    h, a, c = cuda_lstm.recurrence_train_tmajor_plain(xp, wh)
    dz = cuda_lstm.dz_bwd_tmajor_plain(a, c, gout, wh)
    full = [t.clone().requires_grad_() for t in (xin.float(), wx, wh, b)]
    out = cuda_lstm.BiLSTMLayerFn.apply(full[0].bfloat16(), *full[1:], False)
    (out * gout).sum().backward()
    for d in range(2):
        rows = slice(d * B, (d + 1) * B)
        units = slice(d * F, (d + 1) * F)
        xp1 = cuda_lstm.projection_tmajor_plain(
            xin[:, rows].contiguous(), wx[d:d + 1], b[d:d + 1])
        assert torch.equal(xp1, xp[:, rows])
        h1, a1, c1 = cuda_lstm.recurrence_train_tmajor_plain(
            xp1, wh[units])
        same(h1, h[:, rows])
        same(cuda_lstm.recurrence_tmajor_plain(xp1, wh[units]), h1)
        same(a1, a[:, rows])
        assert torch.equal(cuda_lstm.dz_bwd_tmajor_plain(
            a[:, rows].contiguous(), c[:, rows].contiguous(),
            gout[:, rows].contiguous(), wh[units]), dz[:, rows])
        one = [t.clone().requires_grad_() for t in (
            xin[:, rows].float(), wx[d:d + 1], wh[units], b[d:d + 1])]
        out1 = cuda_lstm.BiLSTMLayerFn.apply(one[0].bfloat16(), *one[1:],
                                             False)
        (out1 * gout[:, rows]).sum().backward()
        same(out1, out[:, rows])
        for o, f, part in zip(one, full, (
                (slice(None), rows), (slice(d, d + 1),), (units,),
                (slice(d, d + 1),))):
            if exact:
                assert torch.equal(o.grad, f.grad[part])
            else:
                torch.testing.assert_close(o.grad, f.grad[part], rtol=1e-5,
                                           atol=1e-6)


def test_one_direction_wrappers_refuse_a_third_direction():
    with pytest.raises(ValueError):
        cuda_lstm.recurrence_tmajor_plain(torch.zeros(2, 3, 64),
                                          torch.zeros(48, 64))
    with pytest.raises(ValueError):
        cuda_lstm.bilstm_recurrence_tmajor(torch.zeros(2, 3, 64),
                                           torch.zeros(48, 64))
