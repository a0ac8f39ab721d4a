"""Data-parallel training of the port (``idiaptts_torch/parallel/mesh.py``
and the handler's data-parallel step) against the JAX handler's
``shard_map`` step and the port's one-process step.

Two gloo ranks run as subprocesses on the CPU (``RANK``/``WORLD_SIZE``
as torchrun sets them, a free localhost port), each importing only the
port; the JAX side runs in this process on two of conftest's eight
virtual CPU devices (``setup_mesh(2, use_shard_map=True)``), from the
same initial weights (``convert.py``) and the variable-length 8-row
batch of ``tests/unit/test_shard_map_training.py:39-50`` (SGD, lr 0.01,
masked MSE).

Tolerances:
- A float32 model (Conv1d, BatchNorm, Conv1d) isolates the harness: the
  JAX test's own bounds, losses rtol 1e-5, parameters and running
  averages rtol 1e-3 atol 1e-5 (measured 2.3e-7, 3.0e-8).
- The JAX test's model ``RNNDYN-1_RELU_32-1_BiLSTM_128-1_FC_4`` runs bf16
  Dense and LSTM matmuls, which XLA accumulates in bf16 on the CPU and
  the port in float32 (ROADMAP fault 3.2), so the packages' steps differ
  at that scale (measured: losses 4.5e-5 relative, parameters 1.8e-5
  absolute); bound losses rtol 2e-4, parameters rtol 1e-3 atol 1e-4.
  Against the port's one-process step: losses rtol 1e-4 (measured
  3.1e-7); parameters at the JAX test's bounds, rtol 1e-3 atol 1e-5
  (measured 7.0e-7 absolute: a rank sums the bf16-rounded gradient
  products of its rows, one process those of all rows, the split the
  JAX test's GSPMD and shard_map steps differ by too).
- A batch that does not divide runs whole on both ranks: equal to the
  one-process step bit for bit.
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
from idiaptts_torch.parallel import mesh as torch_mesh
from idiaptts_torch.train.acoustic import AcousticModelTrainer
from idiaptts_torch.train.handler import ModularModelHandler

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LSTM_MODEL = "RNNDYN-1_RELU_32-1_BiLSTM_128-1_FC_4"
TRAINER_MODEL = "RNNDYN-1_RELU_32-1_BiLSTM_16-1_FC_67"
D = 12
LR = 0.01

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs two virtual CPU devices")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain CPU path is many small ops: one intra-op thread runs it
    faster, above all beside the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(B=8, lengths=(17, 23, 9, 30, 21, 13, 27, 11), seed=0):
    """test_shard_map_training.py's batch: per-rank mask sums differ, so
    a mean of per-rank loss means would not be the global loss."""
    rng = np.random.RandomState(seed)
    return collate_batch([{
        "x": rng.randn(lengths[i % len(lengths)], D).astype(np.float32),
        "target": rng.randn(lengths[i % len(lengths)], 4).astype(np.float32),
    } for i in range(B)])


def model_config(mod, kind):
    if kind == "lstm":
        cfg = mod.convert_legacy_string(LSTM_MODEL, D)
    else:
        cfg = mod.RNNDyn.Config(in_dim=D, layer_configs=[
            mod.LayerConfig("Conv1dTANH", out_dim=16, kernel_size=3),
            mod.LayerConfig("BatchNorm1d", out_dim=16),
            mod.LayerConfig("Conv1d", out_dim=4, kernel_size=1)])
    cfg.input_names = ("x",)
    cfg.output_names = ("pred",)
    return cfg


def _state(params, batch_stats=None):
    tree = {"params": jax.tree_util.tree_map(np.asarray, params)}
    if batch_stats is not None:
        tree["batch_stats"] = jax.tree_util.tree_map(np.asarray,
                                                     batch_stats)
    return convert.flax_to_state_dict(tree)


def jax_shard_map(kind, batch, steps=2):
    """(initial port state dict, losses, final state dict) of the JAX
    handler's shard_map step over two devices."""
    handler = JaxHandler()
    handler.create_model(model_config(jax_rnn, kind), example_batch=batch)
    hp = JaxHParams.create_hparams()
    hp.learning_rate = LR
    hp.optimiser_type = "SGD"
    handler.set_optimiser(hp)
    handler.set_scheduler(hp)
    handler.set_losses([JaxLoss.Config("mse", "MSELoss", ("pred", "target"),
                                       seq_mask="_seq_mask")])
    init = _state(handler.params, handler.batch_stats)
    handler.setup_mesh(2, use_shard_map=True)
    losses = [handler.process_batches([batch])[0] for _ in range(steps)]
    assert handler._shmap_steps, "the shard_map step never ran"
    return init, losses, _state(handler.params, handler.batch_stats)


def port_handler(kind, state):
    handler = ModularModelHandler(device="cpu")
    handler.create_model(model_config(torch_rnn, kind))
    handler.model.load_state_dict(state)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = LR
    hp.optimiser_type = "SGD"
    handler.set_optimiser(hp)
    handler.set_scheduler(hp)
    handler.set_losses([NamedLoss.Config("mse", "MSELoss", ("pred", "target"),
                                         seq_mask="_seq_mask")])
    return handler


def trainer_hparams(out_dir, num_questions, num_devices=1):
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


# Each rank: the handler scenarios, then the trainer.  Imports only the
# port (and this test module's helpers are not importable there).
WORKER = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["DP_TEST_DIR"])
import dp_helpers as h
from idiaptts_torch.parallel import mesh

torch.set_num_threads(1)
d = os.environ["DP_WORK"]
blob = torch.load(os.path.join(d, "in.pt"), weights_only=False)
m = mesh.initialise_multihost(device="cpu")   # torchrun's environment
out = {"mesh": (m.size, m.rank, str(m.device))}

def rows_log(handler):
    seen = []
    rule = handler.residuals_bf16_for
    handler.residuals_bf16_for = lambda r: (seen.append(r), rule(r))[1]
    return seen

def state(handler):
    return {k: v.detach().clone()
            for k, v in handler.model.state_dict().items()}

for kind, batch_key, steps in (("f32", "batch", 2), ("lstm", "batch", 2),
                               ("lstm", "batch5", 1), ("f32", "batch64", 1)):
    handler = h.port_handler(kind, blob["init_" + kind])
    handler.setup_mesh(2)
    val = handler.process_batches([blob[batch_key]], training=False)[0]
    seen = rows_log(handler)
    losses, states = [], []
    for _ in range(steps):
        losses.append(handler.process_batches([blob[batch_key]])[0])
        states.append(state(handler))
    out[kind + "_" + batch_key] = {"losses": losses, "states": states,
                                   "rows": seen, "val": val}

# replicate: rank 1's weights perturbed, rank 0's copied back.
handler = h.port_handler("lstm", blob["init_lstm"])
if m.rank == 1:
    with torch.no_grad():
        for p in handler.model.parameters():
            p.add_(1.0)
handler.setup_mesh(2)
out["replicated"] = state(handler)

# The generic step: mean-of-rows loss of a linear map.
torch.manual_seed(0)
lin = torch.nn.Linear(3, 2)
opt = torch.optim.SGD(lin.parameters(), lr=0.1)
step = mesh.make_sharded_train_step(
    lambda b: ((lin(b["x"]) - b["y"]) ** 2).mean(), opt, m)
out["generic"] = {"loss": float(step(blob["generic"])),
                  "weight": lin.weight.detach().clone()}

trainer = h.acoustic_trainer(blob["fixtures"], blob["ids"],
                             h.trainer_hparams(blob["out_dir"],
                                               blob["num_questions"], 2),
                             blob["num_questions"])
saves = []
save = trainer.model_handler.save_checkpoint
trainer.model_handler.save_checkpoint = \
    lambda *a, **k: (saves.append(1), save(*a, **k))[1]
val_loss, train_loss = trainer.train(trainer.hparams)
listing = sorted(os.listdir(os.path.join(blob["out_dir"], "acoustic", "nn")))
trainer.save_checkpoint(trainer.hparams, epoch=9)
fresh = h.ModularModelHandler(device="cpu")
fresh.load_checkpoint(blob["out_dir"], "acoustic", epoch=9)
out["trainer"] = {"val": val_loss, "train": train_loss, "listing": listing,
                  "state": state(trainer.model_handler),
                  "loaded": {k: v.clone()
                             for k, v in fresh.model.state_dict().items()},
                  "writer": trainer.is_writer, "saves": len(saves),
                  "tensorboard": trainer.summary_writer is not None}
torch.save(out, os.path.join(d, "out{}.pt".format(m.rank)))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, fixtures_dir, id_list, num_questions):
    work = tmp_path_factory.mktemp("dp")
    batch = make_batch()
    blob = {"batch": batch,
            "batch5": make_batch(B=5, lengths=(17, 23, 9, 30, 21)),
            "batch64": make_batch(B=64, lengths=(3, 5, 7, 4), seed=1),
            "generic": {"x": torch.randn(6, 3,
                                         generator=torch.Generator()
                                         .manual_seed(1)),
                        "y": torch.randn(6, 2, generator=torch.Generator()
                                         .manual_seed(2))},
            "fixtures": fixtures_dir, "ids": list(id_list),
            "num_questions": num_questions,
            "out_dir": str(work / "trainer")}
    jax_runs = {}
    for kind in ("f32", "lstm"):
        init, losses, final = jax_shard_map(kind, batch)
        blob["init_" + kind] = init
        jax_runs[kind] = {"losses": losses, "final": final}
    torch.save(blob, work / "in.pt")
    # The worker imports this module's helpers without JAX: a copy of
    # the port-only part.
    helpers = work / "dp_helpers.py"
    helpers.write_text(
        "import os\nfrom idiaptts_torch.hparams import ExtendedHParams\n"
        "from idiaptts_torch.models import rnn_dyn as torch_rnn\n"
        "from idiaptts_torch.models.losses import NamedLoss\n"
        "from idiaptts_torch.train.acoustic import AcousticModelTrainer\n"
        "from idiaptts_torch.train.handler import ModularModelHandler\n"
        "LSTM_MODEL, TRAINER_MODEL, D, LR = {!r}, {!r}, {}, {}\n".format(
            LSTM_MODEL, TRAINER_MODEL, D, LR)
        + "\n".join(_source(f) for f in (model_config, port_handler,
                                         trainer_hparams,
                                         acoustic_trainer)))
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               DP_WORK=str(work), DP_TEST_DIR=str(work),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER], cwd=str(work),
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(work / "out{}.pt".format(r), weights_only=False)
             for r in range(2)]
    return {"blob": blob, "jax": jax_runs, "ranks": ranks, "work": work}


def _source(fn):
    import inspect
    return inspect.getsource(fn)


def _one_process(kind, blob, batch_key, steps):
    handler = port_handler(kind, blob["init_" + kind])
    losses = [handler.process_batches([blob[batch_key]])[0]
              for _ in range(steps)]
    return handler, losses


def test_ranks_join_the_group_torchrun_style(runs):
    assert [r["mesh"] for r in runs["ranks"]] == [(2, 0, "cpu"),
                                                 (2, 1, "cpu")]


def test_two_ranks_match_jax_shard_map_float32(runs):
    """The JAX test's bounds on a float32 model, BatchNorm included."""
    ref = runs["jax"]["f32"]
    for rank in runs["ranks"]:
        got = rank["f32_batch"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        final = got["states"][-1]
        assert sorted(final) == sorted(ref["final"])
        for name, value in ref["final"].items():
            np.testing.assert_allclose(final[name].numpy(), value.numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=name)


def test_batchnorm_running_averages_are_the_mean_over_ranks(runs):
    """After one step the running averages are the mean of each rank's
    own update on its rows (the JAX ``pmean`` of batch_stats), which is
    not the whole batch's update."""
    blob = runs["blob"]
    per_rank = []
    for r in range(2):
        model = model_config(torch_rnn, "f32").create_model()
        model.load_state_dict(blob["init_f32"])
        rows = torch_mesh.shard_batch(blob["batch"],
                                      torch_mesh.DataMesh(2, r, "cpu"))
        with torch.no_grad():
            model({"x": torch.as_tensor(rows["x"])},
                  lengths=torch.as_tensor(rows["_lengths"]["x"]),
                  training=True)
        per_rank.append(model.state_dict())
    one, _ = _one_process("f32", blob, "batch", 1)
    for rank in runs["ranks"]:
        after = rank["f32_batch"]["states"][0]
        for leaf in ("mean", "var"):
            name = "wrapped.g1_BatchNorm1d." + leaf
            want = (per_rank[0][name] + per_rank[1][name]) / 2
            torch.testing.assert_close(after[name], want, rtol=1e-6,
                                       atol=1e-9)
            assert not torch.allclose(after[name], one.model.state_dict()[
                name], rtol=1e-7, atol=0)


def test_two_ranks_match_one_process(runs):
    """The JAX test's BiLSTM model: two ranks against one process."""
    one = port_handler("lstm", runs["blob"]["init_lstm"])
    # Evaluation runs whole on every rank: the one-process value.
    val = one.process_batches([runs["blob"]["batch"]], training=False)[0]
    assert runs["ranks"][0]["lstm_batch"]["val"] == pytest.approx(
        val, rel=1e-6)
    losses = [one.process_batches([runs["blob"]["batch"]])[0]
              for _ in range(2)]
    for rank in runs["ranks"]:
        got = rank["lstm_batch"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
        for name, value in one.model.state_dict().items():
            torch.testing.assert_close(got["states"][-1][name], value,
                                       rtol=1e-3, atol=1e-5)


def test_two_ranks_match_jax_shard_map_bilstm(runs):
    """The JAX test's model at bf16 scale (module docstring)."""
    ref = runs["jax"]["lstm"]
    got = runs["ranks"][0]["lstm_batch"]
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4)
    for name, value in ref["final"].items():
        np.testing.assert_allclose(got["states"][-1][name].numpy(),
                                   value.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_ranks_stay_equal(runs):
    a, b = (r["lstm_batch"]["states"][-1] for r in runs["ranks"])
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_nondivisible_batch_runs_whole(runs):
    """Five rows over two ranks: every rank runs the whole batch, as the
    JAX handler falls back from shard_map, and the step equals the one
    process's bit for bit."""
    one, losses = _one_process("lstm", runs["blob"], "batch5", 1)
    for rank in runs["ranks"]:
        got = rank["lstm_batch5"]
        assert got["rows"][0] == 5
        assert got["losses"] == losses
        for name, value in one.model.state_dict().items():
            assert torch.equal(got["states"][0][name], value), name


@pytest.mark.parametrize("batch_key,rows", [("batch", [4, 4]),
                                            ("batch64", [32])])
def test_per_rank_rows_decide_residual_precision(runs, batch_key, rows):
    """The BiLSTM residuals' type is chosen from a rank's rows: 64 rows
    over two ranks are 32 a rank, float32 residuals, where one process
    would choose bf16 (the JAX ``per_dev_b //= data_axis_size``)."""
    kind = "lstm" if batch_key == "batch" else "f32"
    got = runs["ranks"][0]["{}_{}".format(kind, batch_key)]["rows"]
    assert got[:len(rows)] == rows
    handler = ModularModelHandler(device="cpu")
    assert handler.residuals_bf16_for(64) \
        and not handler.residuals_bf16_for(32)


def test_replicate_copies_rank_zero(runs):
    a, b = (r["replicated"] for r in runs["ranks"])
    init = runs["blob"]["init_lstm"]
    for name in a:
        assert torch.equal(a[name], b[name]) and torch.equal(
            a[name], init[name]), name


def test_generic_sharded_train_step(runs):
    """make_sharded_train_step on a mean-of-rows loss: the one-process
    step on the whole batch."""
    blob = runs["blob"]["generic"]
    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(lin.parameters(), lr=0.1)
    loss = ((lin(blob["x"]) - blob["y"]) ** 2).mean()
    loss.backward()
    opt.step()
    for rank in runs["ranks"]:
        assert rank["generic"]["loss"] == pytest.approx(loss.item(),
                                                        rel=1e-6)
        torch.testing.assert_close(rank["generic"]["weight"], lin.weight,
                                   rtol=1e-6, atol=1e-7)


def test_trainer_rank0_writes_and_both_ranks_load(runs):
    """Only rank 0 has a TensorBoard writer; the checkpoints it saved
    (between barriers) are there for both ranks, which load the same
    weights they trained."""
    r0, r1 = (r["trainer"] for r in runs["ranks"])
    assert r0["writer"] and not r1["writer"]
    assert r0["saves"] > 0 and r1["saves"] == 0
    assert r0["tensorboard"] and not r1["tensorboard"]
    assert os.path.isdir(os.path.join(runs["blob"]["out_dir"], "acoustic",
                                      "tensorboard"))
    assert r0["listing"] == r1["listing"]
    assert "params_best" in r0["listing"]
    for rank in (r0, r1):
        for name, value in r0["state"].items():
            assert torch.equal(rank["loaded"][name], value), name
            assert torch.equal(rank["state"][name], value), name


def test_trainer_matches_one_process(runs, fixtures_dir, id_list,
                                     num_questions, tmp_path):
    """One epoch of AcousticModelTrainer over two ranks (batches of 2, 2
    and a last one of 1, which runs whole) against one process."""
    hp = trainer_hparams(str(tmp_path), num_questions)
    trainer = acoustic_trainer(fixtures_dir, id_list, hp, num_questions)
    val_loss, train_loss = trainer.train(hp)
    got = runs["ranks"][0]["trainer"]
    np.testing.assert_allclose(got["train"], train_loss, rtol=1e-4)
    np.testing.assert_allclose(got["val"], val_loss, rtol=1e-4)


def test_shard_batch_gives_the_jax_rows():
    """Rank r's rows are JAX device r's shard; a leaf that does not
    divide stays whole."""
    batch = make_batch()
    sharded = jax_mesh.shard_batch({"x": batch["x"], "odd": np.arange(5)},
                                   jax_mesh.make_data_mesh(2))
    for r in range(2):
        mesh = torch_mesh.DataMesh(2, r, "cpu")
        rows = torch_mesh.shard_batch({"x": torch.as_tensor(batch["x"]),
                                       "odd": np.arange(5)}, mesh)
        shard = next(s for s in sharded["x"].addressable_shards
                     if s.index[0].start == r * 4)
        np.testing.assert_array_equal(rows["x"].numpy(),
                                      np.asarray(shard.data))
        np.testing.assert_array_equal(rows["odd"], np.arange(5))


def test_mesh_without_a_group_and_model_parallel():
    """Without a group of two ranks, model_parallel=2 raises ValueError,
    from the handler and the trainer, as the JAX handler does for a mesh
    that model_parallel does not divide."""
    mesh = torch_mesh.make_data_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.distributed) == (1, 0, False)
    with pytest.raises(ValueError, match="num_devices=2"):
        torch_mesh.make_data_mesh(2, device="cpu")
    handler = ModularModelHandler(device="cpu")
    with pytest.raises(ValueError, match="model_parallel=2 does not divide"):
        handler.setup_mesh(model_parallel=2)
    hp = ExtendedHParams.create_hparams("model_parallel=2")
    hp.device = "cpu"
    with pytest.raises(ValueError, match="model_parallel=2 needs a group"):
        AcousticModelTrainer(hp, ["a"])
